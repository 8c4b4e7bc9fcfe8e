"""Squelch parameters and state (KiwiSDR `SET squelch=…` surface).

Counterpart of `supersdr_tpu/ops/squelch.py`'s squelch types. The gate
itself is not in slice 1: a config with `squelch_enabled=True` raises
`NotImplementedError` (ROADMAP queue 1 #2). The state still travels through
`ChainState` so a state can move between the packages unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SquelchParams(NamedTuple):
    enabled: torch.Tensor     # 0/1
    thresh_db: torch.Tensor   # open threshold (RSSI dB)
    hyst_db: torch.Tensor     # close at thresh − hyst
    ramp: torch.Tensor        # per-sample gain slew


def make_squelch(enabled: bool = False, thresh_db: float = -100.0,
                 hyst_db: float = 6.0, ramp_samples: int = 240,
                 device=None) -> SquelchParams:
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)
    return SquelchParams(enabled=f32(1.0 if enabled else 0.0),
                         thresh_db=f32(thresh_db), hyst_db=f32(hyst_db),
                         ramp=f32(1.0 / max(ramp_samples, 1)))


class SquelchState(NamedTuple):
    open_: torch.Tensor   # gate state (0/1)
    gain: torch.Tensor    # current ramp gain 0..1


def init_squelch(batch_shape: tuple[int, ...] = (),
                 device=None) -> SquelchState:
    return SquelchState(
        open_=torch.ones(batch_shape, dtype=torch.float32, device=device),
        gain=torch.ones(batch_shape, dtype=torch.float32, device=device))
