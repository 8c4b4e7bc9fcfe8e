"""Passband filter plan and history.

Counterpart of `supersdr_tpu/ops/overlap_save.py`'s plan and carry. The
slice filters inside the chain-tail kernel; what it shares with the
reference is the carried history: the last n_taps−1 input samples per
channel, `[*batch, n_taps−1]`.
"""

from __future__ import annotations

from dataclasses import dataclass

from supersdr_tpu.ops import firdesign
from supersdr_tpu_torch.ops import cx


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


def plan_for(block: int, n_taps: int) -> OSPlan:
    return OSPlan(block=block, n_taps=n_taps,
                  fft_size=firdesign.next_pow2(block + n_taps - 1))


def init_carry(plan: OSPlan, batch_shape: tuple[int, ...] = (),
               device=None) -> cx.CX:
    """Zero history [*batch, n_taps−1]."""
    return cx.zeros(batch_shape + (plan.overlap,), device=device)
