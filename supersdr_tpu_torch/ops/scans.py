"""First-order recurrences along the last axis, evaluated in parallel.

Counterpart of `supersdr_tpu/ops/scans.py`:

  linear   y[n] = a[n]·y[n−1] + b[n]        one-pole IIR, DC block
  max-plus y[n] = max(y[n−1] + a[n], b[n])  dB-domain peak tracker
  saturating y[n] = clip(y[n−1] + a[n], lo, hi)  ADPCM step index, sample

Both compose associatively, so a log-depth doubling scan evaluates them
exactly up to float rounding; the time-constant forms use the reference's
blocked Toeplitz product and its single cumulative max (`torch.cummax`
stands for the reference's `blocked_cummax`, a TPU memory-pass saving).

Every scan also runs across a time-sharded axis, where the reference takes
`axis_name` inside `shard_map`: with `shard_axis=-2` the input is `[*batch,
D, n_local]`, each shard scans its block, the per-shard compositions (A, B)
are gathered (`comm.gather_summaries`, 2·D scalars a scan), and each shard
folds the shards before it, in order, onto `y0`, which then seeds global
shard 0 only. The fold is sequential in the global shard index as the
reference's, so the sharded result re-associates nothing the reference
does not. `comm` is the mesh's transport (`parallel/collectives.py`; None:
every shard in this process, halos by the halo kernel): it gathers the
summaries, numbers the shards and moves the neighbouring samples, in this
process or across processes. `parallel/collectives` stands here where
`jax.lax`'s collectives stand in the reference's scans; it is the one
module of `parallel/` that `ops` imports, and it imports nothing of
`parallel/` itself (only the halo kernel's wrapper).
"""

from __future__ import annotations

import torch

from supersdr_tpu_torch.parallel import collectives
from supersdr_tpu_torch.parallel.collectives import left_context, left_halo

__all__ = ["linear_scan", "linear_scan_const", "maxplus_scan",
           "maxplus_scan_const", "saturating_add_scan", "one_pole",
           "dc_block", "sliding_max", "left_halo", "left_context"]


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _align_y0(y0, b: torch.Tensor, sharded: bool = False) -> torch.Tensor:
    """y0 (scalar or [*batch]) shaped to broadcast against b with a
    singleton scan axis (and, sharded, a singleton shard axis)."""
    y0 = _as_tensor(y0, b)
    if y0.ndim == b.ndim:
        return y0
    if y0.ndim == 0:
        return y0.reshape((1,) * b.ndim)
    return y0[..., None, None] if sharded else y0.unsqueeze(-1)


def _check_shard_axis(shard_axis, b: torch.Tensor) -> bool:
    if shard_axis is None:
        return False
    if shard_axis not in (-2, b.ndim - 2) or b.ndim < 2:
        raise NotImplementedError("the shard axis is the one before the "
                                  "scan axis: [*batch, D, n_local]")
    return True


def _fold_preceding_shards(A: torch.Tensor, B: torch.Tensor, y0, apply_op,
                           comm) -> torch.Tensor:
    """y at each shard's start, [*batch, D_local, 1]: the gathered
    summaries of the global shards j < s applied in order to y0 (A, B
    [*batch, D_local, n]: the local scans, whose last column is each
    shard's composition)."""
    comm = comm or collectives.LOCAL
    sum_a = comm.gather_summaries(A[..., -1:])            # [D, *batch, 1]
    sum_b = comm.gather_summaries(B[..., -1:])
    my = comm.shard_index(B)                              # [D_local, 1]
    y_in = torch.broadcast_to(_align_y0(y0, B, sharded=True),
                              B[..., :1].shape)
    for j in range(sum_a.shape[0]):
        y_next = apply_op(y_in, sum_a[j].unsqueeze(-2),
                          sum_b[j].unsqueeze(-2))
        y_in = torch.where(j < my, y_next, y_in)
    return y_in


def _shift(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """x shifted s samples later along the last axis, `fill` in front."""
    s = min(s, x.shape[-1])
    return torch.cat([x.new_full(x.shape[:-1] + (s,), fill),
                      x[..., :x.shape[-1] - s]], dim=-1)


def linear_scan(a, b: torch.Tensor, y0, shard_axis: int | None = None,
                comm=None) -> torch.Tensor:
    """y[n] = a[n]·y[n−1] + b[n] with y[−1] = y0. With `shard_axis` the
    recurrence runs across the time shards (of `comm`); y0 then seeds
    shard 0."""
    sharded = _check_shard_axis(shard_axis, b)
    A = torch.broadcast_to(_as_tensor(a, b), b.shape)
    B = b
    s = 1
    while s < b.shape[-1]:
        B = B + A * _shift(B, s, 0.0)
        A = A * _shift(A, s, 1.0)
        s *= 2
    if sharded:
        y0 = _fold_preceding_shards(A, B, y0,
                                    lambda y, sa, sb: sa * y + sb, comm)
    return A * _align_y0(y0, b) + B


def linear_scan_const(a, b: torch.Tensor, y0, block: int = 128
                      ) -> torch.Tensor:
    """`linear_scan` with a time-constant coefficient: within a block the
    scan is the lower-triangular Toeplitz product with T[i, j] = a^(i−j),
    and the block carries chain through a short scan (as the
    reference)."""
    n = b.shape[-1]
    if n % block:
        return linear_scan(a, b, y0)
    a = _as_tensor(a, b)
    nb = n // block
    i = torch.arange(block, device=b.device)
    expo = (i[:, None] - i[None, :])
    T = torch.where(expo >= 0, a ** expo.clamp_min(0).to(b.dtype),
                    torch.zeros((), dtype=b.dtype, device=b.device))
    w = b.reshape(*b.shape[:-1], nb, block) @ T.T           # [.., nb, S]
    w_end = w[..., -1]
    c = linear_scan(a ** block, w_end, y0)                   # [.., nb]
    y0b = torch.broadcast_to(_align_y0(y0, c), c[..., :1].shape)
    c_prev = torch.cat([y0b, c[..., :-1]], dim=-1)
    y = w + (a ** (i + 1).to(b.dtype)) * c_prev[..., None]
    return y.reshape(b.shape)


def maxplus_scan(a, b: torch.Tensor, y0, shard_axis: int | None = None,
                 comm=None) -> torch.Tensor:
    """y[n] = max(y[n−1] + a[n], b[n]) with y[−1] = y0; `shard_axis` as
    in `linear_scan`."""
    sharded = _check_shard_axis(shard_axis, b)
    A = torch.broadcast_to(_as_tensor(a, b), b.shape)
    B = b
    s = 1
    while s < b.shape[-1]:
        B = torch.maximum(_shift(B, s, -torch.inf) + A, B)
        A = A + _shift(A, s, 0.0)
        s *= 2
    if sharded:
        y0 = _fold_preceding_shards(
            A, B, y0, lambda y, sa, sb: torch.maximum(y + sa, sb), comm)
    return torch.maximum(A + _align_y0(y0, b), B)


def maxplus_scan_const(a, b: torch.Tensor, y0) -> torch.Tensor:
    """`maxplus_scan` with a time-constant step: with s[j] = b[j] − j·a,
    y[n] = n·a + max(cummax(s)[n], y0 + a)."""
    n = b.shape[-1]
    j = torch.arange(n, dtype=b.dtype, device=b.device)
    a = _as_tensor(a, b)
    cm = torch.cummax(b - j * a, dim=-1).values
    y0b = _as_tensor(y0, b)
    if y0b.ndim < b.ndim:
        y0b = y0b[..., None]
    return j * a + torch.maximum(cm, y0b + a)


def saturating_add_scan(a: torch.Tensor, lo: int, hi: int, y0: int
                        ) -> torch.Tensor:
    """y[n] = min(max(y[n−1] + a[n], lo), hi) with y[−1] = y0, exact in
    int64 (a: integer tensor [n]). Each step is the map x ↦ clip(x + a,
    l, h); two of them compose to one, clip(x + a1 + a2, clip(l1 + a2, l2,
    h2), clip(h1 + a2, l2, h2)), so a doubling scan over the (a, l, h)
    triples evaluates the recurrence in log-depth."""
    big = 1 << 62          # the identity's open bounds, far from overflow
    A = a.to(torch.int64)
    L = torch.full_like(A, lo)
    H = torch.full_like(A, hi)
    s = 1
    while s < A.shape[-1]:
        pa, pl, ph = _shift(A, s, 0), _shift(L, s, -big), _shift(H, s, big)
        L, H = (torch.minimum(torch.maximum(pl + A, L), H),
                torch.minimum(torch.maximum(ph + A, L), H))
        A = pa + A
        s *= 2
    return torch.minimum(torch.maximum(A + y0, L), H)


def one_pole(x: torch.Tensor, coeff, y0, shard_axis: int | None = None,
             comm=None) -> torch.Tensor:
    """One-pole smoother y[n] = coeff·y[n−1] + (1 − coeff)·x[n]."""
    coeff = _as_tensor(coeff, x)
    return linear_scan(coeff, (1.0 - coeff) * x, y0, shard_axis=shard_axis,
                       comm=comm)


def dc_block(x: torch.Tensor, r, y0_x, y0_y, shard_axis: int | None = None,
             comm=None
             ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """DC blocker y[n] = x[n] − x[n−1] + r·y[n−1]; returns (y, (last x,
    last y)) so the state threads across blocks. With `shard_axis`, x[n−1]
    at a shard's start comes from the left neighbour (shard 0: y0_x), the
    IIR part runs across the shards, and the returned state holds every
    shard's ([*batch, D]: the stream's is the last one)."""
    r = _as_tensor(r, x)
    if _check_shard_axis(shard_axis, x):
        x_prev0 = torch.broadcast_to(_as_tensor(y0_x, x),
                                     x.shape[:-2]).contiguous()
        first = (comm or collectives.LOCAL).left_halo(
            x, 1, head0=x_prev0[..., None])
        diff = x - torch.cat([first, x[..., :-1]], dim=-1)
        y = linear_scan(r, diff, y0_y, shard_axis=shard_axis, comm=comm)
        return y, (x[..., -1], y[..., -1])
    x_prev0 = torch.broadcast_to(_as_tensor(y0_x, x), x[..., 0].shape)
    diff = x - torch.cat([x_prev0[..., None], x[..., :-1]], dim=-1)
    if r.ndim == 0:
        y = linear_scan_const(r, diff, y0_y)
    else:
        y = linear_scan(r, diff, y0_y)
    return y, (x[..., -1], y[..., -1])


def sliding_max(x: torch.Tensor, window: int, shard_axis: int | None = None,
                comm=None) -> torch.Tensor:
    """Causal sliding-window max over `window` samples (inclusive), as if
    x were left-padded with −inf: a log-depth cascade of shifted maxima,
    exact. With `shard_axis` the window reaches into the shards on the
    left through `left_context` (−inf past the stream's start)."""
    if window <= 1:
        return x
    if _check_shard_axis(shard_axis, x):
        ctx = (comm or collectives.LOCAL).left_context(x, window - 1,
                                                       fill=-torch.inf)
        return sliding_max(torch.cat([ctx, x], dim=-1),
                           window)[..., window - 1:]
    y = x
    covered = 1
    while covered < window:
        s = min(covered, window - covered)
        y = torch.maximum(y, _shift(y, s, -torch.inf))
        covered += s
    return y
