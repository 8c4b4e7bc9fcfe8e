"""Squelch gate and noise blanker (KiwiSDR `SET squelch=…` / `SET nb=…`).

Counterpart of `supersdr_tpu/ops/squelch.py`:

  squelch  opens at thresh, closes below thresh − hyst on the block RSSI;
           the gain ramps linearly toward the gate within the block, and
           the carried gain is the ramp's closed form at the block end;
  blanker  zeroes IQ samples whose envelope exceeds thresh_ratio × the
           block's median envelope, dilated by ±spread samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SquelchParams(NamedTuple):
    enabled: torch.Tensor     # 0/1
    thresh_db: torch.Tensor   # open threshold (RSSI dB)
    hyst_db: torch.Tensor     # close at thresh − hyst
    ramp: torch.Tensor        # per-sample gain slew


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def make_squelch(enabled: bool = False, thresh_db: float = -100.0,
                 hyst_db: float = 6.0, ramp_samples: int = 240,
                 device=None) -> SquelchParams:
    return SquelchParams(enabled=_f32(1.0 if enabled else 0.0, device),
                         thresh_db=_f32(thresh_db, device),
                         hyst_db=_f32(hyst_db, device),
                         ramp=_f32(1.0 / max(ramp_samples, 1), device))


class SquelchState(NamedTuple):
    open_: torch.Tensor   # gate state (0/1)
    gain: torch.Tensor    # current ramp gain 0..1


def init_squelch(batch_shape: tuple[int, ...] = (),
                 device=None) -> SquelchState:
    return SquelchState(
        open_=torch.ones(batch_shape, dtype=torch.float32, device=device),
        gain=torch.ones(batch_shape, dtype=torch.float32, device=device))


def _open_now(params: SquelchParams, state: SquelchState,
              rssi_db: torch.Tensor) -> torch.Tensor:
    """The gate after this block's RSSI, with hysteresis (1 = open)."""
    opens = (rssi_db >= params.thresh_db).float()
    closes = (rssi_db < params.thresh_db - params.hyst_db).float()
    open_now = torch.clamp(state.open_ + opens - closes, 0.0, 1.0)
    return torch.where(params.enabled > 0, open_now,
                       torch.ones_like(open_now))


def apply_squelch(params: SquelchParams, state: SquelchState,
                  audio: torch.Tensor, rssi_db: torch.Tensor
                  ) -> tuple[SquelchState, torch.Tensor]:
    """audio [*batch, n] (or a complex IQ block); rssi_db [*batch]."""
    n = audio.shape[-1]
    open_now = _open_now(params, state, rssi_db)
    t = torch.arange(1, n + 1, dtype=torch.float32, device=audio.device)
    target = open_now[..., None]
    g0 = state.gain[..., None]
    sgn = torch.sign(target - g0)
    lo, hi = torch.minimum(g0, target), torch.maximum(g0, target)
    gain = torch.clamp(g0 + sgn * params.ramp * t, lo, hi)
    g_last = torch.clamp(g0 + sgn * (params.ramp * n), lo, hi)[..., 0]
    return SquelchState(open_=open_now, gain=g_last), audio * gain


def apply_squelch_tmajor(params: SquelchParams, state: SquelchState,
                         audioT: torch.Tensor, rssi_db: torch.Tensor
                         ) -> tuple[SquelchState, torch.Tensor]:
    """The same gate on time-major audio [n, C], rssi_db [C]."""
    st, out = apply_squelch(params, state, audioT.T.float(), rssi_db)
    return st, out.T.to(audioT.dtype)


class BlankerParams(NamedTuple):
    enabled: torch.Tensor
    thresh_ratio: torch.Tensor  # envelope / median-envelope trigger


def make_blanker(enabled: bool = False, thresh_ratio: float = 6.0,
                 device=None) -> BlankerParams:
    return BlankerParams(enabled=_f32(1.0 if enabled else 0.0, device),
                         thresh_ratio=_f32(thresh_ratio, device))


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, keepdims; for an even length the mean
    of the two middle values, as numpy's (`torch.median` returns the
    lower one)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])[..., None]


def apply_blanker(params: BlankerParams, iq: torch.Tensor,
                  spread: int = 2) -> torch.Tensor:
    """Zero impulses in an IQ block [*batch, n] (complex)."""
    env = iq.abs()
    hit = env > params.thresh_ratio * torch.clamp_min(_median(env), 1e-12)
    mask = hit
    for s in range(1, spread + 1):
        mask = mask | torch.roll(hit, s, dims=-1) | torch.roll(hit, -s,
                                                                dims=-1)
    blanked = torch.where(mask, torch.zeros_like(iq), iq)
    return torch.where(params.enabled > 0, blanked, iq)
