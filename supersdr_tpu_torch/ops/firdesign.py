"""FIR filter design (host-side numpy, float64).

The reference's design rules (`supersdr_tpu/ops/firdesign.py`), taken over
as they are so the port imports nothing of the JAX package: a
Blackman-windowed sinc with N = ceil(4 / (fl/fs)) taps forced odd and unity
DC gain, complex bandpass taps made by modulating that prototype to the
passband centre, their zero-padded frequency response, the raised-cosine
brickwall mask and the polyphase decomposition.
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


def freq_response(taps: np.ndarray, fft_size: int) -> np.ndarray:
    """Zero-padded DFT of the taps: the H of overlap-save."""
    return np.fft.fft(taps, n=fft_size)


def brickwall_mask(fft_size: int, fs: float, low_cut: float, high_cut: float,
                   transition: float = 100.0) -> np.ndarray:
    """Frequency-domain passband mask with raised-cosine edges
    `transition` Hz wide, bins in `np.fft.fftfreq` order: applied to the
    overlap-save spectrum in place of designed taps."""
    f = np.fft.fftfreq(fft_size, d=1.0 / fs)

    def edge(x):  # 0 below -transition, 1 above +transition, cosine between
        t = np.clip((x / max(transition, 1e-9)) * 0.5 + 0.5, 0.0, 1.0)
        return 0.5 - 0.5 * np.cos(np.pi * t)

    return (edge(f - low_cut) * edge(high_cut - f)).astype(np.float64)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def polyphase_decompose(taps: np.ndarray, n_branches: int) -> np.ndarray:
    """Prototype taps as a zero-padded [taps a branch, n_branches]
    polyphase matrix, branch p holding taps[p::n_branches]."""
    n = len(taps)
    per = int(np.ceil(n / n_branches))
    padded = np.zeros(per * n_branches, dtype=taps.dtype)
    padded[:n] = taps
    return padded.reshape(per, n_branches)
