"""Blocked-Toeplitz FIR tables for the in-tail passband.

Counterpart of the host-side parts of `supersdr_tpu/ops/fir_matmul.py`
that the FIR-fused chain tail reads. A K-tap FIR over a stream blocked
at B samples is Y_i = Z_i·W with Z_i = x[(i−n_prev)·B : (i+1)·B] and
Wt[s, o] = h[o − s + n_prev·B]: the plain tail applies W as written,
and the CUDA tail reads the taps back out of it (column 0, reversed).
"""

from __future__ import annotations

import numpy as np


def build_w_free(B: int, n_prev: int, taps: np.ndarray) -> np.ndarray:
    """[2W, 2B] complex-folded Toeplitz matrix (W = (n_prev+1)·B): rows
    [0, W) contract the re plane, [W, 2W) the im plane; column o < B
    yields y.re[o], column B+o yields y.im[o]."""
    taps = np.asarray(taps)
    K = len(taps)
    S = (n_prev + 1) * B
    p = n_prev * B
    o = np.arange(B)[None, :]
    s = np.arange(S)[:, None]
    k = o - s + p
    valid = (k >= 0) & (k < K)
    kc = np.clip(k, 0, K - 1)
    wr = np.where(valid, np.real(taps)[kc], 0.0)
    wi = np.where(valid, np.imag(taps)[kc], 0.0)
    return np.block([[wr, wi], [-wi, wr]]).astype(np.float32)


def build_w_free_real(B: int, n_prev: int, taps: np.ndarray) -> np.ndarray:
    """[W, B] real Toeplitz matrix for (numerically) real taps: y.re and
    y.im filter separately with it — half the MACs of the complex form."""
    taps = np.asarray(taps)
    if np.abs(np.imag(taps)).max() > 1e-10 * np.abs(taps).max():
        raise ValueError("build_w_free_real needs (numerically) real taps")
    h = np.real(taps)
    K = len(h)
    S = (n_prev + 1) * B
    p = n_prev * B
    o = np.arange(B)[None, :]
    s_ = np.arange(S)[:, None]
    k = o - s_ + p
    valid = (k >= 0) & (k < K)
    kc = np.clip(k, 0, K - 1)
    return np.where(valid, h[kc], 0.0).astype(np.float32)


def taps_are_real(taps: np.ndarray) -> bool:
    taps = np.asarray(taps)
    return bool(np.abs(np.imag(taps)).max()
                <= 1e-10 * max(float(np.abs(taps).max()), 1e-30))


def tail_fir_block(chunk: int, n_taps: int, tile_t: int
                   ) -> tuple[int, int] | None:
    """(B, n_prev) for the in-tail passband: the least window work
    (n_prev+1)·B with n_prev·B ≥ n_taps−1, B | tile_t, B ≥ 64 and a
    multiple of 8. None when no such block exists (short filters)."""
    ov = n_taps - 1
    if ov < 64:
        return None
    best = None
    for b in range(64, tile_t + 1, 8):
        if tile_t % b:
            continue
        n_prev = -(-ov // b)
        if n_prev * b > tile_t:
            continue
        key = ((n_prev + 1) * b, n_prev)
        if best is None or key < best[0]:
            best = (key, (b, n_prev))
    return best[1] if best else None
