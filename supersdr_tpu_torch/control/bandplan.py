"""HF band plan → automatic mode selection.

Reference `get_auto_mode` (utils_supersdr.py:1303-1318):
ITU/IARU band tables, frequency in kHz rounded to int; outside any band the
generic rule applies (LSB below 10 MHz, USB above).
"""

from __future__ import annotations

TENMHZ = 10000

AUTOMODE_BANDS: dict[str, tuple[tuple[int, int], ...]] = {
    "USB": ((14100, 14350), (18110, 18168), (21150, 21450), (24930, 24990),
            (28300, 29100)),
    "LSB": ((1840, 1850), (3600, 3800), (7060, 7200)),
    "CW": ((1810, 1840), (3500, 3600), (7000, 7060), (10100, 10150),
           (14000, 14100), (18068, 18110), (21000, 21150), (24890, 24930),
           (28000, 28190)),
    "AM": ((148, 283), (520, 1720), (2300, 2500), (3200, 3400), (3900, 4000),
           (4750, 5060), (5900, 6200), (7200, 7450), (9400, 9900),
           (11600, 12100), (13570, 13870), (15100, 15800), (17480, 17900),
           (18900, 19020), (21450, 21850), (25670, 26100)),
}


def get_auto_mode(freq_khz: float) -> str:
    f = round(freq_khz)
    for mode, ranges in AUTOMODE_BANDS.items():
        for lo, hi in ranges:
            if lo <= f < hi:
                return mode
    return "USB" if f > TENMHZ else "LSB"
