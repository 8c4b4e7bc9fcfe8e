"""RSSI from the passband signal, the S-meter's wire codec and its display
ballistics (the reference's `ops/smeter.py`)."""

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


def encode_smeter_u16(rssi: torch.Tensor) -> torch.Tensor:
    """Inverse of the SND-header decode: u16 = 10·(rssi + 127)."""
    return torch.clamp(torch.round((rssi + 127.0) * 10.0), 0,
                       65535).to(torch.uint16)


def decode_smeter_u16(raw: torch.Tensor) -> torch.Tensor:
    return 0.1 * raw.to(torch.float32) - 127.0


def smooth(prev: torch.Tensor, rssi: torch.Tensor, attack: float = 0.5,
           decay: float = 0.1) -> torch.Tensor:
    """Display ballistics: fast rise, slow fall."""
    coeff = torch.where(rssi > prev, attack, decay)
    return prev + coeff * (rssi - prev)


def s_units(rssi: torch.Tensor) -> torch.Tensor:
    """Map dBm-convention RSSI to S-units (S9 = -73 dBm, 6 dB per unit)."""
    return (rssi + 127.0) / 6.0
