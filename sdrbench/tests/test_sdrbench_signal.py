"""The generator: the same seed gives the same traffic, another seed other
values at the same sizes; and the live schedule's due times."""

import numpy as np
import pytest
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



def _keyed(seed, share, period, on):
    sig = dict(SIG, keying={"share": share, "period_chunks": period,
                            "on_chunks": on})
    return signal.make_capture(sig, 256, 256 * 12000, 2, 64, seed, "cpu")


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 3_000_000_001])
def test_keying_draws_a_share_of_the_carriers_and_their_chunks(seed):
    c = _keyed(seed, 0.5, 2, 1)
    assert make(seed).keys is None and c.keys.shape == (32, 2)
    switched = ~c.keys.all(1)
    assert switched.sum() == 16 and (c.keys[switched].sum(1) == 1).all()
    assert not np.array_equal(c.keys, _keyed(seed + 1, 0.5, 2, 1).keys)


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 3_000_000_001])
def test_keyed_on_is_the_steady_capture_and_keyed_off_its_noise(seed):
    """Every carrier keyed on throughout gives the steady capture of the
    seed to the last bit of rounding; every carrier keyed off leaves the
    same seed's noise alone, at the noise's own level."""
    steady = make(seed)
    on, off = _keyed(seed, 1.0, 1, 1), _keyed(seed, 1.0, 1, 0)
    assert on.keys.all() and not off.keys.any()
    for a in ("re", "im"):
        d = getattr(steady, a).int() - getattr(on, a).int()
        assert d.abs().max() <= 1
        rms = getattr(off, a).double().pow(2).mean().sqrt() / signal.I16_FULL
        assert abs(rms / SIG["noise_rms"] - 1) < 0.01
        rms_steady = getattr(steady, a).double().pow(2).mean().sqrt()
        assert rms_steady / signal.I16_FULL > 1.1 * SIG["noise_rms"]
