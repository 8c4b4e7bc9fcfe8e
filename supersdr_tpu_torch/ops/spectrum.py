"""Streaming FFT spectrum + waterfall pipeline.

Counterpart of `supersdr_tpu/ops/spectrum.py`: windowed FFT power rows
over the tuned span (`torch.fft`, cuFFT on the card), the KiwiSDR
waterfall's calibration `-(255-wf) - 13 + 3·zoom`, percentile
auto-leveling (P40/P100 with a ≥ 40 dB minimum displayed range), 0..254
color normalization and LINRAD-style N× time-binned averaging, batched
over rows so a whole waterfall history is a few tensor ops.

The percentiles come from one `torch.sort` with the reference's linear
interpolation (`jnp.percentile`'s: float32 position q·(n−1), weights
1 − frac and frac), not from `torch.quantile`, which refuses inputs of
more than 2^24 elements (16384 rows of 1024 bins).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from supersdr_tpu_torch.device import default_device
from supersdr_tpu_torch.ops import cx

MIN_DYN_RANGE_DB = 40.0     # kiwi_waterfall.MIN_DYN_RANGE
CLIP_LOW_PERCENTILE = 40.0  # kiwi_waterfall.CLIP_LOWP
CLIP_HIGH_PERCENTILE = 100.0
KIWI_WF_CAL_DB = -13.0


def spectrum_window(nfft: int, kind: str = "hann",
                    device=None) -> torch.Tensor:
    """Window normalized for coherent gain (a full-scale tone reads ~0
    dBFS), float32 on `device` (default: the current CUDA device)."""
    if kind == "hann":
        w = np.hanning(nfft)
    elif kind == "blackman":
        w = np.blackman(nfft)
    elif kind == "rect":
        w = np.ones(nfft)
    else:
        raise ValueError(kind)
    w = w / np.sum(w) * nfft
    return torch.from_numpy(w.astype(np.float32)).to(default_device(device))


def power_spectrum_db(iq, window: torch.Tensor,
                      cal_db: float = KIWI_WF_CAL_DB) -> torch.Tensor:
    """Windowed FFT power rows. iq: [*batch, nfft] complex tensor (or CX)
    → [*batch, nfft] dB, fftshifted so bin 0 is the low edge of the
    span."""
    if isinstance(iq, cx.CX):
        iq = torch.complex(iq.re, iq.im)
    nfft = iq.shape[-1]
    X = torch.fft.fftshift(torch.fft.fft(iq * window, dim=-1), dim=-1)
    p = (torch.abs(X) / nfft) ** 2
    return 10.0 * torch.log10(torch.clamp_min(p, 1e-30)) + cal_db


def segment_rows(iq, nfft: int, hop: int | None = None):
    """Split a long IQ block into FFT rows. iq [..., n] → [..., rows,
    nfft], for real, complex and CX inputs: a reshape when hop == nfft,
    overlapping windows (a strided view) otherwise."""
    if isinstance(iq, cx.CX):
        return cx.CX(segment_rows(iq.re, nfft, hop),
                     segment_rows(iq.im, nfft, hop))
    hop = hop or nfft
    n = iq.shape[-1]
    rows = (n - nfft) // hop + 1
    if hop == nfft:
        return iq[..., : rows * nfft].reshape(*iq.shape[:-1], rows, nfft)
    return iq.unfold(-1, nfft, hop)


def waterfall_rows_db(iq, window: torch.Tensor, nfft: int,
                      hop: int | None = None,
                      cal_db: float = KIWI_WF_CAL_DB) -> torch.Tensor:
    """IQ (CX, complex numpy or tensor; moved to the window's device) →
    [rows, nfft] dB: segmentation, window, FFT, power, calibration."""
    z = cx.as_cx(iq, device=window.device)
    rows = segment_rows(torch.complex(z.re, z.im), nfft, int(hop or nfft))
    return power_spectrum_db(rows, window, float(cal_db))


def time_binned_average(rows_db: torch.Tensor, n_avg: int) -> torch.Tensor:
    """LINRAD-style averaging: mean of every n_avg consecutive rows in the
    linear power domain, returned in dB. rows_db [..., R, bins]; rows past
    the last whole group are dropped."""
    if n_avg <= 1:
        return rows_db
    shape = rows_db.shape
    r = shape[-2] // n_avg
    g = rows_db[..., : r * n_avg, :].reshape(*shape[:-2], r, n_avg, shape[-1])
    p = torch.pow(10.0, g / 10.0)
    return 10.0 * torch.log10(torch.clamp_min(torch.mean(p, dim=-2), 1e-30))


class AutoLevel(NamedTuple):
    color: torch.Tensor     # [..., bins] float 0..255 (clipped at 254 scale)
    low_db: torch.Tensor    # chosen low clip (per row)
    high_db: torch.Tensor
    dyn_range: torch.Tensor


def _percentile(sorted_rows: torch.Tensor, p: float) -> torch.Tensor:
    """`jnp.percentile(x, p, axis=-1, keepdims=True)` (linear) of rows
    already sorted along the last axis."""
    n = sorted_rows.shape[-1]
    pos = np.float32(np.float32(p) / np.float32(100.0)) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(1.0) - w_hi
    lo, hi = min(max(lo, 0), n - 1), min(max(hi, 0), n - 1)
    return (sorted_rows[..., lo:lo + 1] * float(w_lo)
            + sorted_rows[..., hi:hi + 1] * float(w_hi))


def autolevel(row_db: torch.Tensor,
              auto: bool = True,
              low_clip_db: float = -120.0,
              high_clip_db: float = -60.0,
              delta_low_db: float = 0.0,
              delta_high_db: float = 0.0,
              clip_lowp: float = CLIP_LOW_PERCENTILE,
              clip_highp: float = CLIP_HIGH_PERCENTILE,
              min_dyn_range: float = MIN_DYN_RANGE_DB) -> AutoLevel:
    """Percentile auto-leveling → colormap indices, the reference's
    semantics. row_db: [..., bins]. When `auto`, the low/high clips are the
    P40/P100 of each row; the displayed dynamic range is at least
    `min_dyn_range` dB. Returns color values scaled 0..254 then clipped to
    0..255, and the per-row dB window used."""
    if auto:
        s = torch.sort(row_db, dim=-1).values
        low = _percentile(s, clip_lowp)
        high = _percentile(s, clip_highp)
    else:
        low = torch.full(row_db.shape[:-1] + (1,), low_clip_db,
                         dtype=row_db.dtype, device=row_db.device)
        high = torch.full(row_db.shape[:-1] + (1,), high_clip_db,
                          dtype=row_db.dtype, device=row_db.device)
    dyn = torch.clamp_min(high - low, min_dyn_range)
    shifted = row_db - (low + delta_low_db)
    norm = (dyn + delta_high_db) - delta_low_db
    color = torch.clamp(shifted / norm, 0.0, 1.0) * 254.0
    color = torch.clamp(color, 0.0, 255.0)
    return AutoLevel(color=color,
                     low_db=(low + delta_low_db)[..., 0],
                     high_db=(low + norm)[..., 0],
                     dyn_range=dyn[..., 0])


def kiwi_byte_to_db(wf_bytes: torch.Tensor, zoom: int) -> torch.Tensor:
    """Wire-format compatibility: a KiwiSDR uint8 waterfall row to dB,
    `-(255-b) - 13 + 3·zoom`. The first bin is broken server-side and is
    replaced by its neighbour, as the reference does."""
    db = -(255.0 - wf_bytes.to(torch.float32)) - 13.0 + 3.0 * zoom
    return torch.cat([db[..., 1:2], db[..., 1:]], dim=-1)


def scroll(history: torch.Tensor, new_row: torch.Tensor) -> torch.Tensor:
    """Waterfall history update: shift rows down one, the new row on
    top."""
    return torch.cat([new_row[..., None, :], history[..., :-1, :]], dim=-2)


def spectrum_scope_row(history_color: torch.Tensor,
                       n_rows: int = 15) -> torch.Tensor:
    """Scope trace = mean of the newest n_rows waterfall rows."""
    return torch.mean(history_color[..., :n_rows, :], dim=-2)
