"""The deployment's filters and channel layout, worked out again from the
numbers in a configuration file (float64 numpy).

The design rules are the receiver's published ones: a Blackman-windowed
sinc with unity DC gain for every lowpass (the polyphase prototype, the
passband, the audio interpolator), the passband modulated to its centre,
and the L-branch polyphase split of the interpolator. This file is a
frozen copy of those rules; it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

# largest DFT factor of the channelizer's two-stage DFT
MAX_FACTOR = 256


def lowpass_taps_n(fl: float, fs: float, n: int) -> np.ndarray:
    """Blackman-windowed sinc, cutoff fl at rate fs, n (odd) taps, unity
    DC gain."""
    if n % 2 == 0:
        raise ValueError("tap count must be odd")
    h = np.sinc(2.0 * fl / fs * (np.arange(n) - (n - 1) / 2.0))
    h *= np.blackman(n)
    return h / np.sum(h)


def lowpass_taps(fl: float, fs: float) -> np.ndarray:
    """The same rule with n = ceil(4·fs/fl) taps, forced odd."""
    n = int(np.ceil(4.0 / (fl / fs)))
    return lowpass_taps_n(fl, fs, n + 1 - n % 2)


def pfb_prototype(n_chan: int, taps_per: int) -> np.ndarray:
    """The channelizer's prototype: cutoff fs/(2M), M·K taps (designed at
    M·K + 1 and the last dropped when M·K is even), unity DC gain."""
    n = n_chan * taps_per
    if n % 2 == 0:
        proto = lowpass_taps_n(0.5 / n_chan, 1.0, n + 1)[:-1]
    else:
        proto = lowpass_taps_n(0.5 / n_chan, 1.0, n)
    return proto / proto.sum()


def passband_taps(band: tuple[float, float], iq_rate: float, n_taps: int
                  ) -> np.ndarray:
    """Complex passband taps for `band` (low and high cut, Hz): a lowpass
    of half the width, modulated to the passband's centre."""
    lo, hi = band
    center, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    proto = lowpass_taps_n(half, iq_rate, n_taps)
    m = np.arange(n_taps) - (n_taps - 1) / 2.0
    return proto * np.exp(2j * np.pi * center / iq_rate * m)


def interp_matrix(iq_rate: int, audio_rate: int) -> np.ndarray:
    """The L× interpolator as P [per, L]: audio[n·L + p] = Σ_m P[m, p]·
    x[n − (per − 1) + m], lowpass at iq_rate/2 designed at audio_rate."""
    if audio_rate % iq_rate:
        raise ValueError("the reference interpolates by an integer factor")
    L = audio_rate // iq_rate
    taps = lowpass_taps(iq_rate / 2.0, audio_rate)
    per = -(-len(taps) // L)
    P = np.zeros((per, L))
    for p in range(L):
        for m in range(per):
            j = (per - 1 - m) * L + p
            if j < len(taps):
                P[m, p] = taps[j]
    return P * L


def dft_factors(n_chan: int) -> tuple[int, int]:
    """(n1, n2), M = n1·n2, of the channelizer's two-stage DFT: n2 = 256
    or 128 where that leaves n1 ≤ 256, else the largest n2 ≤ 256."""
    for n2 in (256, 128, *range(min(MAX_FACTOR, n_chan - 1), 0, -1)):
        if n_chan % n2 == 0 and n_chan // n2 <= MAX_FACTOR:
            return n_chan // n2, n2
    raise ValueError(f"no two-stage factoring of {n_chan}")


def planar_order(n_chan: int) -> np.ndarray:
    """order[row] = channel (DFT bin) of an output row on the planar
    layout: row k1·n2 + k2 holds bin k2·n1 + k1."""
    n1, n2 = dft_factors(n_chan)
    rows = np.arange(n_chan)
    return (rows % n2) * n1 + rows // n2


def identity_order(n_chan: int) -> np.ndarray:
    """order[row] = channel: rows in bin order."""
    return np.arange(n_chan)


# the layouts a configuration's `rows` may name
ROW_ORDERS = {"planar": planar_order, "identity": identity_order}


def row_order(layout: str, n_chan: int) -> np.ndarray:
    """The bin of each output row on the layout a configuration names."""
    return ROW_ORDERS[layout](n_chan)


def channel_freqs(n_chan: int, fs: float) -> np.ndarray:
    """Centre of each bin, Hz, wrapped to ±fs/2."""
    f = np.arange(n_chan) * fs / n_chan
    f[f >= fs / 2] -= fs
    return f
