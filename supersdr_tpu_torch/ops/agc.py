"""AGC parameters and state (KiwiSDR `SET agc=…` surface).

Counterpart of `supersdr_tpu/ops/agc.py`'s parameter and state types;
the AGC itself (peak tracker, kneed gain law, attack one-pole) runs
inside the chain-tail kernel, `ops/cuda/chain_tail.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MANUAL_UNITY_DB = 50.0
ENV_FLOOR = 1e-9


class AGCParams(NamedTuple):
    """Runtime AGC parameters, 0-d float32 tensors."""
    on: torch.Tensor                    # 1 = auto, 0 = manual gain
    hang: torch.Tensor                  # 1 = hang enabled
    thresh_db: torch.Tensor             # knee, dBFS
    slope_db: torch.Tensor              # output rise over thresh→0
    decay_per_sample_db: torch.Tensor
    man_gain_db: torch.Tensor
    target_db: torch.Tensor
    attack_coeff: torch.Tensor          # one-pole gain smoothing


def make_params(fs: float, on: bool = True, hang: bool = False,
                thresh_db: float = -80.0, slope_db: float = 0.0,
                decay_ms: float = 4000.0, man_gain_db: float = 50.0,
                target_db: float = -10.0, attack_ms: float = 5.0,
                device=None) -> AGCParams:
    """`decay_ms`: time for the tracked peak to fall 60 dB. The attack
    coefficient is exp(−1/(attack·fs)) rounded once to float32."""
    PEAK_DROP_DB = 60.0
    decay_per_sample = PEAK_DROP_DB / (max(decay_ms, 1e-3) * 1e-3 * fs)
    attack_coeff = np.exp(-1.0 / (max(attack_ms, 1e-3) * 1e-3 * fs))

    def f32(v):
        return torch.tensor(np.float32(v), dtype=torch.float32,
                            device=device)
    return AGCParams(on=f32(1.0 if on else 0.0),
                     hang=f32(1.0 if hang else 0.0),
                     thresh_db=f32(thresh_db), slope_db=f32(slope_db),
                     decay_per_sample_db=f32(decay_per_sample),
                     man_gain_db=f32(man_gain_db), target_db=f32(target_db),
                     attack_coeff=f32(attack_coeff))


class AGCState(NamedTuple):
    peak_db: torch.Tensor   # tracked envelope peak at the end of a block
    gain_db: torch.Tensor   # smoothed gain at the end of a block


def init_state(batch_shape: tuple[int, ...] = (), device=None) -> AGCState:
    return AGCState(
        peak_db=torch.full(batch_shape, -120.0, dtype=torch.float32,
                           device=device),
        gain_db=torch.zeros(batch_shape, dtype=torch.float32, device=device))


def hang_samples(fs: float, hang_ms: float = 500.0) -> int:
    return max(1, int(round(hang_ms * 1e-3 * fs)))
