"""Batched overlap-save FFT convolution (the chain's "fft" passband).

Counterpart of `supersdr_tpu/ops/overlap_save.py`. Each block's segment is
its predecessor's last n_taps−1 input samples (or the carried history for
the first block) followed by the block, so every block of a chunk filters
in one batched `torch.fft` (cuFFT on the card) — no recurrence. The
carried history is the last n_taps−1 input samples, `[*batch, n_taps−1]`,
the same state the matmul passband and the fused tail carry.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from supersdr_tpu_torch.ops import cx, firdesign


@dataclass(frozen=True)
class OSPlan:
    """block: samples per step; n_taps: FIR length; fft_size: pow2 ≥
    block + n_taps − 1."""
    block: int
    n_taps: int
    fft_size: int

    @property
    def overlap(self) -> int:
        return self.n_taps - 1

    @property
    def seg_len(self) -> int:
        return self.block + self.n_taps - 1


def plan_for(block: int, n_taps: int) -> OSPlan:
    return OSPlan(block=block, n_taps=n_taps,
                  fft_size=firdesign.next_pow2(block + n_taps - 1))


def taps_to_freq(plan: OSPlan, taps: np.ndarray, device=None) -> cx.CX:
    """The taps' response at the plan's FFT size (float64 FFT on the
    host, float32 planes on `device`)."""
    if len(taps) != plan.n_taps:
        raise ValueError(f"taps length {len(taps)} != plan n_taps "
                         f"{plan.n_taps}")
    H = np.fft.fft(np.asarray(taps), n=plan.fft_size)
    return cx.CX(torch.from_numpy(H.real.astype(np.float32)).to(device),
                 torch.from_numpy(H.imag.astype(np.float32)).to(device))


def init_carry(plan: OSPlan, batch_shape: tuple[int, ...] = (),
               device=None) -> cx.CX:
    """Zero history [*batch, n_taps−1]."""
    return cx.zeros(batch_shape + (plan.overlap,), device=device)


def overlap_save_batch_c(plan: OSPlan, H: torch.Tensor, head: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Filter stacked blocks x [*batch, n_blocks, block] (complex) with the
    response H ([fft] or per-slot [*batch, 1, fft]); head [*batch,
    n_taps−1] is the history before the first block. Returns y [*batch,
    n_blocks, block] = convolve(history ‖ x, taps, "valid") block by
    block."""
    x = x.to(torch.complex64)
    head = head.to(torch.complex64)
    n_blocks = x.shape[-2]
    ov = plan.overlap
    if ov <= plan.block:
        if ov:
            heads = torch.cat([head[..., None, :],
                               x[..., :-1, plan.block - ov:]], dim=-2)
            segs = torch.cat([heads, x], dim=-1)
        else:
            segs = x
    else:
        flat = torch.cat([head, x.reshape(*x.shape[:-2], -1)], dim=-1)
        idx = (torch.arange(n_blocks, device=x.device)[:, None] * plan.block
               + torch.arange(plan.seg_len, device=x.device)[None, :])
        segs = flat[..., idx]
    X = torch.fft.fft(segs, n=plan.fft_size, dim=-1)
    y = torch.fft.ifft(X * H, dim=-1)
    return y[..., ov: ov + plan.block]
