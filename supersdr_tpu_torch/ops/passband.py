"""Per-mode default passbands (the reference's `ops/passband.py` rule,
taken over as it is): SSB 30-3000 Hz (LSB mirrored), AM ±6 kHz, CW
400-800 Hz around the 600 Hz pitch, NBFM ±6 kHz and IQ ±5 kHz."""

from __future__ import annotations

CW_PITCH_HZ = 600.0
LOW_CUT_SSB = 30
HIGH_CUT_SSB = 3000
LOW_CUT_CW = int(CW_PITCH_HZ - 200)
HIGH_CUT_CW = int(CW_PITCH_HZ + 200)
HIGHLOW_CUT_AM = 6000
LIB_DEFAULT_PASSBANDS = {"NBFM": (-6000, 6000), "IQ": (-5000, 5000)}


class UnknownModulation(ValueError):
    pass


def supersdr_passband(mode: str, delta_low: float = 0.0,
                      delta_high: float = 0.0) -> tuple[float, float]:
    """(low_cut, high_cut) in Hz for a mode, widened by the user's
    deltas."""
    mode = mode.upper()
    if mode == "USB":
        return (LOW_CUT_SSB + delta_low, HIGH_CUT_SSB + delta_high)
    if mode == "LSB":
        return (-HIGH_CUT_SSB - delta_high, -LOW_CUT_SSB - delta_low)
    if mode == "AM":
        return (-HIGHLOW_CUT_AM - delta_low, HIGHLOW_CUT_AM + delta_high)
    if mode == "CW":
        return (LOW_CUT_CW + delta_low, HIGH_CUT_CW + delta_high)
    if mode in LIB_DEFAULT_PASSBANDS:
        return LIB_DEFAULT_PASSBANDS[mode]
    raise UnknownModulation(mode)
