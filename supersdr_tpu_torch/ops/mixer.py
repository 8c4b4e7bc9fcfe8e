"""NCO / complex mixer with a drift-free streaming phase.

Counterpart of `supersdr_tpu/ops/mixer.py`: the per-block phase ramp and
the block's phase increment are built on the host in float64 and wrapped
mod 1, and the phase is carried as a fraction of a cycle in [0, 1), so
float32 never sees a large phase.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class NCOParams(NamedTuple):
    ramp: torch.Tensor        # [*batch, block] (n·f) mod 1
    block_inc: torch.Tensor   # [*batch] (block·f) mod 1

    @staticmethod
    def make(freq_hz, fs: float, block: int, device=None) -> "NCOParams":
        """freq_hz: a scalar or a [*batch] array of frequencies."""
        f = np.asarray(freq_hz, np.float64) / np.float64(fs)
        n = np.arange(block, dtype=np.float64)
        ramp = np.mod(f[..., None] * n, 1.0)
        inc = np.mod(np.float64(block) * f, 1.0)
        return NCOParams(
            ramp=torch.from_numpy(ramp.astype(np.float32)).to(device),
            block_inc=torch.from_numpy(
                np.asarray(inc, np.float32)).to(device))


def init_phase(batch_shape: tuple[int, ...] = (),
               device=None) -> torch.Tensor:
    return torch.zeros(batch_shape, dtype=torch.float32, device=device)


def mix(params: NCOParams, phase: torch.Tensor, x: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x·exp(+j2π(phase + ramp)) → (new phase, y); pass −f to
    `NCOParams.make` to shift a signal at +f down to baseband."""
    ph = torch.remainder(phase[..., None] + params.ramp, 1.0)
    osc = torch.exp((2j * np.pi) * ph)
    return torch.remainder(phase + params.block_inc, 1.0), x * osc
