"""Polyphase resampling: L× interpolation (12 kHz → 48 kHz) and rational
L/M (20.25 kHz kiwis → 48 kHz).

Counterpart of `supersdr_tpu/ops/resample.py`. The zero-stuff +
valid-convolve + ×L reference pipeline equals
y[n·L + p] = Σ_m P[m, p]·x[n − (per−1) + m], P[m, p] = L·h[(per−1−m)·L + p]:
`interpolate` applies it as a product with P ("einsum") or as a chain of
shifted multiply-adds ("fma"); `interpolate_matmul` as a blocked Toeplitz
product whose columns already interleave the output. All three carry the
last per−1 inputs. The fused chain tail applies the same P in its kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from supersdr_tpu_torch.ops import fir_matmul, firdesign


@dataclass(frozen=True)
class InterpPlan:
    """Streaming L× interpolator; per = ceil(n_taps / L) taps a branch."""
    L: int
    n_taps: int
    per: int

    @property
    def history(self) -> int:
        return self.per - 1


def design_interp(kiwi_rate: int, audio_rate: int
                  ) -> tuple[InterpPlan, np.ndarray]:
    """Lowpass at kiwi_rate/2 designed at audio_rate, as the reference."""
    if audio_rate % kiwi_rate:
        raise ValueError("use rational resampling for non-integer ratios")
    taps = firdesign.lowpass_taps(kiwi_rate / 2.0, audio_rate)
    return plan_interp(audio_rate // kiwi_rate, taps)


def plan_interp(L: int, taps: np.ndarray) -> tuple[InterpPlan, np.ndarray]:
    """Polyphase matrix P [per, L] (float64) for L× interpolation."""
    n_taps = len(taps)
    per = int(np.ceil(n_taps / L))
    P = np.zeros((per, L), dtype=np.float64)
    for p in range(L):
        for m in range(per):
            j = (per - 1 - m) * L + p
            if j < n_taps:
                P[m, p] = taps[j]
    P *= L
    return InterpPlan(L=L, n_taps=n_taps, per=per), P


def init_carry(plan: InterpPlan, batch_shape: tuple[int, ...] = (),
               device=None) -> torch.Tensor:
    return torch.zeros(batch_shape + (plan.history,), dtype=torch.float32,
                       device=device)


def interpolate(plan: InterpPlan, P: torch.Tensor, carry: torch.Tensor,
                x: torch.Tensor, impl: str = "einsum"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [*batch, n] → (new carry, y [*batch, n·L])."""
    seg = torch.cat([carry, x], dim=-1)
    n = x.shape[-1]
    if impl == "fma":
        y = seg[..., 0:n, None] * P[0]
        for m in range(1, plan.per):
            y = y + seg[..., m:m + n, None] * P[m]
    else:
        frames = torch.stack([seg[..., m:m + n] for m in range(plan.per)],
                             dim=-1)                    # [..., n, per]
        y = frames @ P
    y = y.reshape(*x.shape[:-1], n * plan.L)
    new_carry = seg[..., -plan.history:] if plan.history else seg[..., :0]
    return new_carry, y


@dataclass(frozen=True)
class InterpMatmulPlan:
    L: int
    n_taps: int
    per: int
    block_in: int   # input samples per matmul row (multiple of 128)

    def __post_init__(self):
        if self.block_in % 128:
            raise ValueError("block_in must be a multiple of 128")

    @property
    def history(self) -> int:
        return self.per - 1

    @property
    def n_prev(self) -> int:
        return -(-self.history // self.block_in)

    @property
    def window(self) -> int:
        return (self.n_prev + 1) * self.block_in


def plan_interp_matmul(plan: InterpPlan, chunk: int,
                       max_block: int = 256) -> InterpMatmulPlan:
    """B ≤ max_block, a 128-multiple divisor of chunk where one exists."""
    b = 128
    for cand in range(max_block, 127, -128):
        if chunk % cand == 0:
            b = cand
            break
    return InterpMatmulPlan(L=plan.L, n_taps=plan.n_taps, per=plan.per,
                            block_in=b)


def build_w_interp(plan: InterpMatmulPlan, taps: np.ndarray,
                   device=None) -> torch.Tensor:
    """[window, L·block_in]: W[s, t·L + p] = L·h[(n_prev·B + t − s)·L + p]
    on the band, else 0 (float64 build, float32 tensor)."""
    taps = np.asarray(taps, np.float64)
    if len(taps) != plan.n_taps:
        raise ValueError("taps length mismatch")
    B, L, per = plan.block_in, plan.L, plan.per
    s = np.arange(plan.window)[:, None]
    t = np.arange(B)[None, :]
    q = plan.n_prev * B + t - s
    W = np.zeros((plan.window, B * L), np.float64)
    for p in range(L):
        j = q * L + p
        valid = (q >= 0) & (q < per) & (j < plan.n_taps)
        W[:, p::L] = np.where(valid, L * taps[np.clip(j, 0, plan.n_taps - 1)],
                              0.0)
    return torch.from_numpy(W.astype(np.float32)).to(device)


def interpolate_matmul(plan: InterpMatmulPlan, Wm: torch.Tensor,
                       carry: torch.Tensor, x: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [*batch, n] → (new carry, y [*batch, n·L]), the same outputs and
    carry as `interpolate`."""
    B = plan.block_in
    n = x.shape[-1]
    z = fir_matmul.block_windows(B, plan.n_prev, carry,
                                 fir_matmul.pad_block(x, B))
    y = (z @ Wm).reshape(*x.shape[:-1], -1)[..., : n * plan.L]
    new_carry = (torch.cat([carry, x], dim=-1)[..., -plan.history:]
                 if plan.history else x[..., :0])
    return new_carry, y


@dataclass(frozen=True)
class RationalPlan:
    """Streaming L/M rational resampler (e.g. 20.25 kHz → 48 kHz: 64/27)."""
    L: int
    M: int
    n_taps: int

    @property
    def history(self) -> int:
        return self.n_taps - 1  # in the L-upsampled domain


def plan_rational(in_rate: int, out_rate: int,
                  taps: np.ndarray | None = None
                  ) -> tuple[RationalPlan, np.ndarray]:
    g = int(np.gcd(in_rate, out_rate))
    L, M = out_rate // g, in_rate // g
    if taps is None:
        # anti-image and anti-alias lowpass at min(in, out)/2, at L·in
        taps = firdesign.lowpass_taps(min(in_rate, out_rate) / 2.0,
                                      L * in_rate)
    return RationalPlan(L=L, M=M, n_taps=len(taps)), np.asarray(taps)


def rational_resample_block(plan: RationalPlan, taps: torch.Tensor,
                            carry: torch.Tensor, x: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-stuff by L, convolve with the carried upsampled-domain
    history, scale by L and keep every M-th sample: x [*batch, n] (n·L a
    multiple of M) → (new carry, y [*batch, n·L/M])."""
    n = x.shape[-1]
    if (n * plan.L) % plan.M:
        raise ValueError("block length * L must be divisible by M")
    up = x.new_zeros(*x.shape[:-1], n * plan.L)
    up[..., :: plan.L] = x
    seg = torch.cat([carry, up], dim=-1)
    idx = (torch.arange(0, n * plan.L, plan.M, device=x.device)[:, None]
           + torch.arange(plan.n_taps, device=x.device)[None, :])
    y = plan.L * (seg[..., idx] @ taps.flip(0).to(x.dtype))
    return seg[..., -plan.history:], y
