"""RSSI from the passband signal (the reference's `ops/smeter.py`)."""

from __future__ import annotations

import torch

# full-scale (|iq| = 1.0) calibration, dB (typical KiwiSDR waterfall cal)
DEFAULT_CAL_DB = -13.0
RSSI_FLOOR_DB = -127.0


def rssi_db(y: torch.Tensor, cal_db: float = DEFAULT_CAL_DB) -> torch.Tensor:
    """Mean-power RSSI of a block [*batch, n] → [*batch] dB."""
    p = torch.mean(y.abs() ** 2, dim=-1)
    return torch.clamp_min(10.0 * torch.log10(torch.clamp_min(p, 1e-30))
                           + cal_db, RSSI_FLOOR_DB)
