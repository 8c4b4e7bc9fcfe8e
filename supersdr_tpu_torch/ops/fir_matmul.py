"""Streaming FIR as a blocked-Toeplitz matrix product.

Counterpart of `supersdr_tpu/ops/fir_matmul.py`. A K-tap FIR over a stream
blocked at B samples is Y_i = Z_i·W with Z_i = x[(i−n_prev)·B : (i+1)·B]
and Wt[s, o] = h[o − s + n_prev·B]; the complex multiply folds into one
real product by stacking the (re, im) planes along the contraction,
[[Wr, Wi], [−Wi, Wr]]. The carried state is the last n_taps−1 inputs, the
same as overlap-save's. The chain's matmul passbands run these products
as plain `torch.matmul` in float32 (the reference leaves them to XLA; its
precision strings name TPU matrix-unit passes, and off the TPU XLA runs
them in float32 too). The FIR-fused chain tail reads W back for its taps.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from supersdr_tpu_torch.ops import cx


@dataclass(frozen=True)
class FIRMatmulPlan:
    """block: output samples per matmul row (a multiple of 128);
    n_taps: FIR length K."""
    block: int
    n_taps: int

    def __post_init__(self):
        if self.block % 128:
            raise ValueError("block must be a multiple of 128")

    @property
    def overlap(self) -> int:
        return self.n_taps - 1

    @property
    def n_prev(self) -> int:
        return -(-self.overlap // self.block)

    @property
    def window(self) -> int:
        return (self.n_prev + 1) * self.block


def plan_for(chunk: int, n_taps: int, max_block: int = 512) -> FIRMatmulPlan:
    """B ≈ the overlap rounded up to 128, preferring a divisor of chunk."""
    overlap = n_taps - 1
    b = min(max_block, max(128, -(-overlap // 128) * 128))
    d = b
    while d >= 128 and chunk % d:
        d -= 128
    return FIRMatmulPlan(block=d if d >= 128 else b, n_taps=n_taps)


def _toeplitz(S: int, B: int, p: int, h: np.ndarray) -> np.ndarray:
    """Wt[s, o] = h[o − s + p] on the band, else 0."""
    K = len(h)
    k = np.arange(B)[None, :] - np.arange(S)[:, None] + p
    return np.where((k >= 0) & (k < K), h[np.clip(k, 0, K - 1)], 0.0)


def build_w(plan: FIRMatmulPlan, taps: np.ndarray,
            device=None) -> torch.Tensor:
    """[2·window, 2·block] matrix for complex taps: rows [0, window)
    contract the re plane, the rest the im plane; column o < block yields
    y.re[o], column block+o y.im[o]."""
    taps = np.asarray(taps)
    if len(taps) != plan.n_taps:
        raise ValueError(f"taps length {len(taps)} != plan {plan.n_taps}")
    return torch.from_numpy(build_w_free(plan.block, plan.n_prev, taps)
                            ).to(device)


def build_w_real(plan: FIRMatmulPlan, taps: np.ndarray,
                 device=None) -> torch.Tensor:
    """[window, block] matrix for real taps (each plane filters alone)."""
    taps = np.asarray(taps, np.float64)
    if len(taps) != plan.n_taps:
        raise ValueError(f"taps length {len(taps)} != plan {plan.n_taps}")
    w = _toeplitz(plan.window, plan.block, plan.n_prev * plan.block, taps)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def init_carry(plan: FIRMatmulPlan, batch_shape: tuple[int, ...] = (),
               device=None) -> cx.CX:
    return cx.zeros(batch_shape + (plan.overlap,), device=device)


def block_windows(B: int, n_prev: int, carry: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """[*batch, n_blocks, (n_prev + 1)·B] sliding windows of zeros ‖ carry
    ‖ x, for x a multiple of B long and carry at most n_prev·B."""
    nb = x.shape[-1] // B
    pre = x.new_zeros(*x.shape[:-1], n_prev * B - carry.shape[-1])
    xb = torch.cat([pre, carry, x], dim=-1).reshape(
        *x.shape[:-1], nb + n_prev, B)
    return torch.cat([xb[..., j:j + nb, :] for j in range(n_prev + 1)],
                     dim=-1)


def pad_block(x: torch.Tensor, B: int) -> torch.Tensor:
    """x zero-padded along its last axis to a multiple of B."""
    pad_n = (-x.shape[-1]) % B
    return torch.cat([x, x.new_zeros(*x.shape[:-1], pad_n)], -1) \
        if pad_n else x


def _new_carry(plan: FIRMatmulPlan, carry: cx.CX, x: cx.CX) -> cx.CX:
    """The last n_taps−1 inputs (short chunks keep part of the history)."""
    ov, chunk = plan.overlap, x.shape[-1]
    if ov == 0:
        return cx.CX(x.re[..., :0], x.im[..., :0])
    if chunk >= ov:
        return cx.CX(x.re[..., -ov:], x.im[..., -ov:])
    return cx.CX(torch.cat([carry.re[..., chunk:], x.re], dim=-1),
                 torch.cat([carry.im[..., chunk:], x.im], dim=-1))


def fir_matmul_stream_c(plan: FIRMatmulPlan, W: torch.Tensor, carry: cx.CX,
                        x: cx.CX) -> tuple[cx.CX, cx.CX]:
    """One streaming step with W from `build_w`: x [*batch, chunk] →
    (new carry, y) with y = convolve(carry ‖ x, taps, "valid")."""
    B, chunk = plan.block, x.shape[-1]
    z = torch.cat([block_windows(B, plan.n_prev, carry.re,
                                 pad_block(x.re, B)),
                   block_windows(B, plan.n_prev, carry.im,
                                 pad_block(x.im, B))], dim=-1)
    y2 = z @ W
    yr = y2[..., :B].reshape(*x.shape[:-1], -1)[..., :chunk]
    yi = y2[..., B:].reshape(*x.shape[:-1], -1)[..., :chunk]
    return _new_carry(plan, carry, x), cx.CX(yr, yi)


def fir_matmul_stream(plan: FIRMatmulPlan, W: torch.Tensor, carry, x
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """`fir_matmul_stream_c` on CX, complex or real carry and x (numpy or
    tensors), moved to W's device; returns complex64 tensors there."""
    c, y = fir_matmul_stream_c(plan, W, cx.as_cx(carry, W.device),
                               cx.as_cx(x, W.device))
    return torch.complex(c.re, c.im), torch.complex(y.re, y.im)


def fir_matmul_stream_tmajor_c(plan: FIRMatmulPlan, W: torch.Tensor,
                               carry_T: cx.CX, xT: cx.CX
                               ) -> tuple[cx.CX, cx.CX]:
    """The time-major form of `fir_matmul_stream_c`: the batch rides the
    last axis, so the wideband time-major tier filters [chunk, C] planes
    without a transpose. Per time block i, y2_i [2B, C] = Wᵀ·Z_i with
    Z_i [2W, C] the block's (re ‖ im) window rows; the same W (`build_w`)
    and the same carry, held time-major [n_taps−1, C]. xT: [chunk, C]
    with chunk a multiple of the block. Returns (new carry, yT [chunk,
    C])."""
    B, Wn = plan.block, plan.window
    chunk, C = xT.re.shape
    if chunk % B:
        raise ValueError("time-major FIR needs chunk % block == 0")
    nb = chunk // B
    pre = xT.re.new_zeros(plan.n_prev * B - plan.overlap, C)

    def windows(c, x):          # [nb, W, C]: rows i·B … i·B + W of ext
        ext = torch.cat([pre, c, x], dim=0)
        return ext.as_strided((nb, Wn, C), (B * C, C, 1))
    z = torch.cat([windows(carry_T.re, xT.re), windows(carry_T.im, xT.im)],
                  dim=1)                                     # [nb, 2W, C]
    y2 = W.T @ z                                             # [nb, 2B, C]
    yT = cx.CX(y2[:, :B].reshape(chunk, C), y2[:, B:].reshape(chunk, C))
    ov = plan.overlap
    if ov == 0:
        new_carry = cx.CX(xT.re[:0], xT.im[:0])
    elif chunk >= ov:
        new_carry = cx.CX(xT.re[-ov:], xT.im[-ov:])
    else:
        new_carry = cx.CX(torch.cat([carry_T.re[chunk:], xT.re], dim=0),
                          torch.cat([carry_T.im[chunk:], xT.im], dim=0))
    return new_carry, yT


def fir_matmul_stream_real_c(plan: FIRMatmulPlan, W: torch.Tensor,
                             carry: cx.CX, x: cx.CX) -> tuple[cx.CX, cx.CX]:
    """Real taps (W from `build_w_real`) on a complex stream: each plane
    filters through the same [window, block] product."""
    B, chunk = plan.block, x.shape[-1]
    z = torch.stack([block_windows(B, plan.n_prev, carry.re,
                                   pad_block(x.re, B)),
                     block_windows(B, plan.n_prev, carry.im,
                                   pad_block(x.im, B))], dim=-3)
    y2 = z @ W
    yr = y2[..., 0, :, :].reshape(*x.shape[:-1], -1)[..., :chunk]
    yi = y2[..., 1, :, :].reshape(*x.shape[:-1], -1)[..., :chunk]
    return _new_carry(plan, carry, x), cx.CX(yr, yi)


def build_w_free(B: int, n_prev: int, taps: np.ndarray) -> np.ndarray:
    """[2W, 2B] complex-folded Toeplitz matrix (W = (n_prev+1)·B) for any
    block B: rows [0, W) contract the re plane, [W, 2W) the im plane."""
    taps = np.asarray(taps)
    S, p = (n_prev + 1) * B, n_prev * B
    wr = _toeplitz(S, B, p, np.real(taps))
    wi = _toeplitz(S, B, p, np.imag(taps))
    return np.block([[wr, wi], [-wi, wr]]).astype(np.float32)


def build_w_free_real(B: int, n_prev: int, taps: np.ndarray) -> np.ndarray:
    """[W, B] real Toeplitz matrix for (numerically) real taps: y.re and
    y.im filter separately with it — half the MACs of the complex form."""
    taps = np.asarray(taps)
    if np.abs(np.imag(taps)).max() > 1e-10 * np.abs(taps).max():
        raise ValueError("build_w_free_real needs (numerically) real taps")
    return _toeplitz((n_prev + 1) * B, B, n_prev * B,
                     np.real(taps)).astype(np.float32)


def taps_are_real(taps: np.ndarray) -> bool:
    taps = np.asarray(taps)
    return bool(np.abs(np.imag(taps)).max()
                <= 1e-10 * max(float(np.abs(taps).max()), 1e-30))


@lru_cache(maxsize=64)
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
