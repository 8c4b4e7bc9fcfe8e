"""What moves between shards: halos, contexts, scan summaries, the
all_to_all reshard, broadcasts and stage handoffs.

Inside `shard_map` the reference gets these from `jax.lax` (`ppermute`,
`all_gather`, `all_to_all`, `axis_index`: `supersdr_tpu/ops/scans.py`,
`supersdr_tpu/parallel/`). Here a sharded tensor carries its shards on an
explicit axis — `[*batch, D, n_local]` for the time-sharded halos and
scans, a leading `[D, …]` for the reshard, the broadcast and the handoff —
and the functions below are the whole traffic between shards. Every module
above this one (the mesh scans, the demodulators, the AGC, the sharded
chain and wideband pipeline, the distributed FFT, the pipeline) reaches
other shards only through them, so a transport across devices goes here
and nowhere else.

`traffic` counts, in plain integers, the bytes a real mesh would move for
each call: per shard, received, as `parallel/comm_model.py` reckons them
(a halo of n samples over R rows is R·n·itemsize; a gathered summary is
D·R·itemsize; an all_to_all (D−1)/D of a shard's buffer; a broadcast or a
handoff one shard's value).
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
        self.a2a_bytes = 0
        self.carry_bytes = 0
        self.send_bytes = 0
        self.n_collectives = 0

    @property
    def total_bytes(self) -> int:
        return (self.halo_bytes + self.summary_bytes + self.a2a_bytes
                + self.carry_bytes + self.send_bytes)


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


def _shard_bytes(t: torch.Tensor) -> int:
    """Bytes of one shard's value of a `[D, …]` tensor."""
    return math.prod(t.shape[1:]) * t.element_size()


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """The reference's tiled `jax.lax.all_to_all` over a leading shard
    axis: x `[D, *s]` → `[D, *s']`, where shard j receives block j of
    every shard's `split_axis` (which D must divide) and lays them side
    by side along `concat_axis`, in shard order (axes count from 0 within
    a shard's `[*s]`). One permute-and-copy: the result is contiguous."""
    D = x.shape[0]
    s = list(x.shape[1:])
    if s[split_axis] % D:
        raise ValueError(f"split axis {split_axis} of {tuple(s)} does not "
                         f"divide by {D} shards")
    y = x.reshape(D, *s[:split_axis], D, s[split_axis] // D,
                  *s[split_axis + 1:])
    y = y.movedim(1 + split_axis, 0)      # [dst, src, *s with the block]
    y = y.movedim(1, 1 + concat_axis)     # src right before concat_axis
    s[split_axis] //= D
    s[concat_axis] *= D
    traffic.a2a_bytes += _shard_bytes(x) * (D - 1) // D
    traffic.n_collectives += 1
    return y.reshape(D, *s).contiguous()


def broadcast_last(v: torch.Tensor) -> torch.Tensor:
    """The last shard's value at every shard: `[D, *s]` → `[D, *s]` (the
    reference's `bcast_last`: a binomial ppermute tree of ceil(log2 D)
    rounds, in which each shard receives the value once; on one device a
    broadcast view)."""
    D = v.shape[0]
    if D > 1:
        traffic.carry_bytes += _shard_bytes(v)
        traffic.n_collectives += math.ceil(math.log2(D))
    return v[-1:].expand_as(v)


def send_next(x: torch.Tensor) -> torch.Tensor:
    """Each shard's value to the next shard, `[D, *s]` → `[D, *s]`, shard 0
    receiving zeros (the pipeline's one-hop `ppermute(perm=[(0, 1)])` on
    two shards)."""
    out = torch.zeros_like(x)
    out[1:] = x[:-1]
    traffic.send_bytes += _shard_bytes(x)
    traffic.n_collectives += 1
    return out
