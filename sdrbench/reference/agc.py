"""The receiver's AGC on a demodulated channel: a peak tracker with
instant attack and a linear-in-dB decay, the kneed gain law, and a
one-pole smoother on the gain, as set out in a configuration's
`deployment.agc` block."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sdrbench.reference.scans import linear_scan, maxplus_scan

ENV_FLOOR = 1e-9


class AGCTables(NamedTuple):
    decay_db: float         # peak decay a sample, dB
    attack: float           # gain smoother's coefficient
    thresh_db: float
    slope_db: float
    target_db: float


def tables(agc: dict, rate: float) -> AGCTables:
    """From a configuration's `agc` block, at `rate` samples a second."""
    if not agc["on"] or agc["hang"]:
        raise ValueError("the reference's AGC is on and has no hang")
    return AGCTables(decay_db=60.0 / (agc["decay_ms"] * 1e-3 * rate),
                     attack=math.exp(-1.0 / (agc["attack_ms"] * 1e-3 * rate)),
                     thresh_db=agc["thresh_db"], slope_db=agc["slope_db"],
                     target_db=agc["target_db"])


def apply(t: AGCTables, x: torch.Tensor, peak0: torch.Tensor,
          gain0: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [C, n] → (gained x, tracked peak [C, n], smoothed gain [C, n]),
    from the peak and gain the stream held before the block."""
    x_db = 20.0 * torch.log10(torch.clamp_min(x.abs(), ENV_FLOOR))
    peak = maxplus_scan(t.decay_db, x_db, peak0)
    del x_db
    above = (t.target_db - peak) + t.slope_db * (
        (peak - t.thresh_db) / max(-t.thresh_db, 1e-6))
    gain = torch.where(peak <= t.thresh_db,
                       torch.full_like(peak, t.target_db - t.thresh_db),
                       above)
    smooth = linear_scan(t.attack, (1.0 - t.attack) * gain, gain0)
    return x * torch.pow(10.0, smooth / 20.0), peak, smooth
