"""Demodulation modes and passband conventions.

Reproduces the reference's control surface exactly:
  * per-mode default passbands of the SuperSDR app
    (utils_supersdr.py:45-50 and change_passband at
    utils_supersdr.py:1078-1092)
  * the KiwiSDR client-library defaults (kiwi/client.py:221-245)
  * passband adjustment semantics: 100 Hz steps (÷5 for CW), minimum width
    50 Hz, maximum width 1600 Hz (CW) / 6000 Hz (SSB)
    (supersdr.py:307-373)
  * CW pitch convention: dial frequency = carrier - CW_PITCH, so the carrier
    lands at +600 Hz inside the 400..800 Hz passband
    (supersdr.py:664,709; utils_supersdr.py:41-49).
"""

from __future__ import annotations

from dataclasses import dataclass

CW_PITCH_HZ = 600.0
TENMHZ_KHZ = 10000.0  # auto-mode USB/LSB switchover

LOW_CUT_SSB = 30
HIGH_CUT_SSB = 3000
LOW_CUT_CW = int(CW_PITCH_HZ - 200)
HIGH_CUT_CW = int(CW_PITCH_HZ + 200)
HIGHLOW_CUT_AM = 6000

MODES = ("USB", "LSB", "CW", "AM", "NBFM", "IQ")

# KiwiSDR client-library per-mode defaults (kiwi/client.py:221-245)
LIB_DEFAULT_PASSBANDS = {
    "AM": (-6000, 6000),
    "LSB": (-2700, -300),
    "USB": (300, 2700),
    "CW": (300, 700),
    "NBFM": (-6000, 6000),
    "IQ": (-5000, 5000),
}

PB_STEP_HZ = 100
PB_MIN_WIDTH_HZ = 50
PB_MAX_WIDTH_SSB_HZ = 6000
PB_MAX_WIDTH_CW_HZ = 1600


class UnknownModulation(ValueError):
    pass


def supersdr_passband(mode: str, delta_low: float = 0.0,
                      delta_high: float = 0.0) -> tuple[float, float]:
    """App-level passband for a mode, with user low/high adjustments.

    Mirrors kiwi_sound.change_passband (utils_supersdr.py:1078-1092):
    deltas widen/narrow from the mode defaults; LSB mirrors the SSB band to
    negative frequencies; AM is symmetric.
    """
    mode = mode.upper()
    if mode == "USB":
        return (LOW_CUT_SSB + delta_low, HIGH_CUT_SSB + delta_high)
    if mode == "LSB":
        return (-HIGH_CUT_SSB - delta_high, -LOW_CUT_SSB - delta_low)
    if mode == "AM":
        return (-HIGHLOW_CUT_AM - delta_low, HIGHLOW_CUT_AM + delta_high)
    if mode == "CW":
        return (LOW_CUT_CW + delta_low, HIGH_CUT_CW + delta_high)
    if mode == "NBFM":
        return LIB_DEFAULT_PASSBANDS["NBFM"]
    if mode == "IQ":
        return LIB_DEFAULT_PASSBANDS["IQ"]
    raise UnknownModulation(mode)


def lib_default_passband(mode: str) -> tuple[float, float]:
    try:
        return LIB_DEFAULT_PASSBANDS[mode.upper()]
    except KeyError:
        raise UnknownModulation(mode) from None


def passband_step(mode: str, shift: bool = False) -> int:
    """User adjustment step: 100 Hz, ÷5 for CW; SHIFT flips the sign
    (supersdr.py:311-313)."""
    step = PB_STEP_HZ
    if mode.upper() == "CW":
        step = step // 5
    return -step if shift else step


def clamp_deltas(mode: str, delta_low: float, delta_high: float,
                 old_delta_low: float, old_delta_high: float
                 ) -> tuple[float, float]:
    """Enforce the reference's min/max passband width when adjusting.

    A change that would push the width below 50 Hz or above the per-mode
    maximum (1600 CW / 6000 SSB-family) is rejected: the old deltas are
    returned (supersdr.py:320-339).
    """
    mode = mode.upper()
    if mode == "CW":
        lo, hi, max_w = LOW_CUT_CW, HIGH_CUT_CW, PB_MAX_WIDTH_CW_HZ
    else:
        lo, hi, max_w = LOW_CUT_SSB, HIGH_CUT_SSB, PB_MAX_WIDTH_SSB_HZ
    old_width = (hi + old_delta_high) - (lo + old_delta_low)
    new_width = (hi + delta_high) - (lo + delta_low)
    if new_width < PB_MIN_WIDTH_HZ and new_width < old_width:
        return old_delta_low, old_delta_high
    if new_width > max_w and new_width > old_width:
        return old_delta_low, old_delta_high
    return delta_low, delta_high


@dataclass(frozen=True)
class Passband:
    """A resolved passband in Hz relative to the tuned (dial) frequency."""
    low_cut: float
    high_cut: float

    @property
    def width(self) -> float:
        return self.high_cut - self.low_cut

    @property
    def center(self) -> float:
        return 0.5 * (self.low_cut + self.high_cut)
