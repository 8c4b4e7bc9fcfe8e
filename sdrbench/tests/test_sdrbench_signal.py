"""The generator: the same seed gives the same traffic, another seed other
values at the same sizes; and the live schedule's due times."""

import numpy as np
import torch

from sdrbench import signal
from sdrbench.drivers import live

SIG = {"noise_rms": 0.02, "carrier_every": 8, "carrier_amp": [2e-4, 2e-2],
       "mod_depth": [0.3, 0.8], "tone_hz": [300.0, 3000.0]}


def make(seed):
    return signal.make_capture(SIG, 256, 256 * 12000, 2, 64, seed, "cpu")


def test_same_seed_same_traffic():
    a, b = make(2 ** 31 + 5), make(2 ** 31 + 5)
    assert torch.equal(a.re, b.re) and torch.equal(a.im, b.im)
    assert np.array_equal(a.carrier_bins, b.carrier_bins)


def test_other_seed_same_sizes_other_values():
    a, b = make(3_000_000_001), make(3_000_000_002)
    assert a.re.shape == b.re.shape == (2, 64 * 256)
    assert a.re.dtype == torch.int16
    assert len(a.carrier_bins) == len(b.carrier_bins) == 256 // 8
    assert not torch.equal(a.re, b.re)
    assert a.clipped == b.clipped == 0


def test_carriers_stand_at_their_bins():
    c = make(7)
    z = (c.re.double() + 1j * c.im.double()).reshape(-1, 256)
    power = (torch.fft.fft(z, dim=-1).abs() ** 2).mean(0)
    strongest = set(torch.topk(power, 4).indices.tolist())
    assert strongest <= set(c.carrier_bins.tolist())


def test_live_schedule():
    period = 512 * 2560 / 30_720_000
    assert abs(period - 0.0426666) < 1e-6
    due = live.due_times(100.0, 20.0, period)
    assert len(due) == 468
    assert due[0] == 100.0 + period
    assert np.allclose(np.diff(due), period)
