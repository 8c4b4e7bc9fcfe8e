"""What moves between time shards: halos, contexts and scan summaries.

Inside `shard_map` the reference gets these from `jax.lax` (`ppermute`,
`all_gather`, `axis_index`: `supersdr_tpu/ops/scans.py`). Here a sharded
tensor carries its time shards on an explicit axis, `[*batch, D,
n_local]`, and the functions below are the whole traffic between shards.
Every module above this one (the mesh scans, the demodulators, the AGC,
the sharded chain) reaches other shards only through them, so a transport
across devices goes here and nowhere else.

`traffic` counts, in plain integers, the bytes a real mesh would move for
each call: per time shard, received, as `parallel/comm_model.py` reckons
them (a halo of n samples over R rows is R·n·itemsize; a gathered summary
is D·R·itemsize).
"""

from __future__ import annotations

import math

import torch

from supersdr_tpu_torch.ops.cuda import halo

HALO_IMPLS = ("rdma", "ppermute")


class Traffic:
    """Bytes received by one time shard, and the count of collectives."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.halo_bytes = 0
        self.summary_bytes = 0
        self.n_collectives = 0

    @property
    def total_bytes(self) -> int:
        return self.halo_bytes + self.summary_bytes


traffic = Traffic()


def _rows(t: torch.Tensor) -> int:
    return math.prod(t.shape[:-2])


def _exchange(x, n, fill, hop, head0, out, impl):
    if impl not in HALO_IMPLS:
        raise ValueError(f"halo_impl must be one of {HALO_IMPLS}")
    fn = halo.left_halo if impl == "rdma" else halo.left_halo_plain
    first = x if isinstance(x, torch.Tensor) else x[0]
    n_planes = 1 if isinstance(x, torch.Tensor) else len(x)
    traffic.halo_bytes += _rows(first) * n * first.element_size() * n_planes
    traffic.n_collectives += 1
    return fn(x, n, fill, hop=hop, head0=head0, out=out)


def left_halo(x, n: int, fill: float = 0.0, *, head0=None,
              impl: str = "rdma"):
    """The last `n` samples of the left neighbour's block, `[*batch, D,
    n]`; shard 0 receives `fill`, or `head0` `[*batch, n]` (the carried
    stream state) when given. x: float32, int16 or complex64 `[*batch, D,
    n_local]`, or an (re, im) pair of planes. impl "rdma" is the halo
    kernel on CUDA tensors, "ppermute" the plain slice copy; on the CPU
    both are the plain version."""
    return _exchange(x, n, fill, 1, head0, None, impl)


def left_context(x: torch.Tensor, n: int, fill: float = 0.0, *,
                 impl: str = "rdma") -> torch.Tensor:
    """Like `left_halo` for contexts longer than one shard: the last `n`
    samples of the stream before each shard, `[*batch, D, n]`, from the
    preceding ceil(n / n_local) shards (`fill` past the stream's start).
    One exchange a hop, each moving only the samples the context keeps."""
    local = x.shape[-1]
    hops = -(-n // local)
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    for h in range(hops, 0, -1):
        m = n - (hops - 1) * local if h == hops else local
        lo = n - h * local if h < hops else 0
        _exchange(x, m, fill, h, None, out[..., lo:lo + m], impl)
    return out


def gather_summaries(s: torch.Tensor) -> torch.Tensor:
    """Every shard's summary at every shard: `[*batch, D, 1]` → `[D,
    *batch, 1]` (the reference's `all_gather`; on one device a view)."""
    traffic.summary_bytes += s.shape[-2] * _rows(s) * s.element_size()
    traffic.n_collectives += 1
    return s.movedim(-2, 0)


def shard_index(x: torch.Tensor) -> torch.Tensor:
    """Each shard's index along the time axis, `[D, 1]`, broadcasting
    against `[*batch, D, n]` (the reference's `axis_index`)."""
    return torch.arange(x.shape[-2], device=x.device)[:, None]
