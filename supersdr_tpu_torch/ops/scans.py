"""First-order recurrences along the last axis, evaluated in parallel.

Counterpart of `supersdr_tpu/ops/scans.py` for what the receiver chain
reads (the `axis_name` forms belong to the mesh and are not ported):

  linear   y[n] = a[n]·y[n−1] + b[n]        one-pole IIR, DC block
  max-plus y[n] = max(y[n−1] + a[n], b[n])  dB-domain peak tracker

Both compose associatively, so a log-depth doubling scan evaluates them
exactly up to float rounding; the time-constant forms use the reference's
blocked Toeplitz product and its single cumulative max.
"""

from __future__ import annotations

import torch


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _align_y0(y0, b: torch.Tensor) -> torch.Tensor:
    """y0 (scalar or [*batch]) shaped to broadcast against b with a
    singleton scan axis."""
    y0 = _as_tensor(y0, b)
    if y0.ndim == b.ndim:
        return y0
    if y0.ndim == 0:
        return y0.reshape((1,) * b.ndim)
    return y0.unsqueeze(-1)


def _shift(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """x shifted s samples later along the last axis, `fill` in front."""
    s = min(s, x.shape[-1])
    return torch.cat([x.new_full(x.shape[:-1] + (s,), fill),
                      x[..., :x.shape[-1] - s]], dim=-1)


def linear_scan(a, b: torch.Tensor, y0) -> torch.Tensor:
    """y[n] = a[n]·y[n−1] + b[n] with y[−1] = y0."""
    A = torch.broadcast_to(_as_tensor(a, b), b.shape)
    B = b
    s = 1
    while s < b.shape[-1]:
        B = B + A * _shift(B, s, 0.0)
        A = A * _shift(A, s, 1.0)
        s *= 2
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


def maxplus_scan(a, b: torch.Tensor, y0) -> torch.Tensor:
    """y[n] = max(y[n−1] + a[n], b[n]) with y[−1] = y0."""
    A = torch.broadcast_to(_as_tensor(a, b), b.shape)
    B = b
    s = 1
    while s < b.shape[-1]:
        B = torch.maximum(_shift(B, s, -torch.inf) + A, B)
        A = A + _shift(A, s, 0.0)
        s *= 2
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


def dc_block(x: torch.Tensor, r, y0_x, y0_y
             ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """DC blocker y[n] = x[n] − x[n−1] + r·y[n−1]; returns (y, (last x,
    last y)) so the state threads across blocks."""
    r = _as_tensor(r, x)
    x_prev0 = torch.broadcast_to(_as_tensor(y0_x, x), x[..., 0].shape)
    diff = x - torch.cat([x_prev0[..., None], x[..., :-1]], dim=-1)
    if r.ndim == 0:
        y = linear_scan_const(r, diff, y0_y)
    else:
        y = linear_scan(r, diff, y0_y)
    return y, (x[..., -1], y[..., -1])


def sliding_max(x: torch.Tensor, window: int) -> torch.Tensor:
    """Causal sliding-window max over `window` samples (inclusive), as if
    x were left-padded with −inf: a log-depth cascade of shifted maxima,
    exact."""
    if window <= 1:
        return x
    y = x
    covered = 1
    while covered < window:
        s = min(covered, window - covered)
        y = torch.maximum(y, _shift(y, s, -torch.inf))
        covered += s
    return y
