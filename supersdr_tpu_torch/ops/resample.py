"""Polyphase L× interpolation plan (12 kHz channels → 48 kHz audio).

Counterpart of the integer-ratio plan in `supersdr_tpu/ops/resample.py`.
The zero-stuff + valid-convolve + ×L reference pipeline equals
y[n·L + p] = Σ_m P[m, p]·x[n − (per−1) + m], P[m, p] = L·h[(per−1−m)·L + p];
the chain tail applies it in the kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from supersdr_tpu.ops import firdesign


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
