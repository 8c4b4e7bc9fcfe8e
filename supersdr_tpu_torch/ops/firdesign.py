"""FIR filter design (host-side numpy, float64).

The reference's design rules (`supersdr_tpu/ops/firdesign.py`), taken over
as they are so the port imports nothing of the JAX package: a
Blackman-windowed sinc with N = ceil(4 / (fl/fs)) taps forced odd and unity
DC gain, and complex bandpass taps made by modulating that prototype to the
passband centre.
"""

from __future__ import annotations

import numpy as np


def lowpass_taps(fl: float, fs: float) -> np.ndarray:
    """Blackman-windowed-sinc lowpass: cutoff fl Hz at rate fs Hz,
    N = ceil(4/(fl/fs)) taps forced odd, unity DC gain."""
    n = int(np.ceil(4.0 / (fl / fs)))
    if n % 2 == 0:
        n += 1
    return lowpass_taps_n(fl, fs, n)


def lowpass_taps_n(fl: float, fs: float, n: int) -> np.ndarray:
    """The same design rule with an explicit (odd) tap count."""
    if n % 2 == 0:
        raise ValueError("tap count must be odd")
    h = np.sinc(2.0 * fl / fs * (np.arange(n) - (n - 1) / 2.0))
    h *= np.blackman(n)
    h /= np.sum(h)
    return h.astype(np.float64)


def complex_bandpass_taps(low_cut: float, high_cut: float, fs: float,
                          n: int | None = None) -> np.ndarray:
    """Complex taps passing low_cut..high_cut Hz (cuts may be negative or
    straddle zero): a lowpass of half the width, modulated to the
    centre."""
    if high_cut <= low_cut:
        raise ValueError(f"high_cut ({high_cut}) must exceed low_cut "
                         f"({low_cut})")
    center = 0.5 * (low_cut + high_cut)
    half_width = 0.5 * (high_cut - low_cut)
    proto = (lowpass_taps(half_width, fs) if n is None
             else lowpass_taps_n(half_width, fs, n))
    m = np.arange(len(proto)) - (len(proto) - 1) / 2.0
    return (proto * np.exp(2j * np.pi * center / fs * m)).astype(np.complex128)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
