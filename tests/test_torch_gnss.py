"""The port's copy of `io/gnss.GnssTimekeeper` on the cases of
tests/test_gnss.py, and against the reference's on one stream of frame
headers: the same rate and the same timestamps, bit for bit."""

import numpy as np
import pytest

from supersdr_tpu.io import gnss as jgnss
from supersdr_tpu_torch.io.gnss import GnssTimekeeper


def feed_frames(tk, true_rate, n_frames, frame=512, start=1000.0):
    ts = []
    gps = start
    for _ in range(n_frames):
        sec = int(gps)
        nsec = int((gps - sec) * 1e9)
        t = tk.update(sec, nsec, frame)
        ts.append(t)
        gps += frame / true_rate
    return ts


def test_rate_estimation_converges():
    tk = GnssTimekeeper(nominal_rate=12000)
    feed_frames(tk, 12010.0, 50)
    assert abs(tk.rate - 12010.0) < 0.5
    assert abs(tk.drift_ppm - 833.0) < 50


def test_timestamps_continuous():
    tk = GnssTimekeeper(nominal_rate=12000)
    ts = feed_frames(tk, 12000.0, 10)
    assert ts[0] is None and ts[1] is None
    assert ts[2] is not None
    assert tk.settled
    t_all = np.concatenate([t for t in ts if t is not None])
    dt = np.diff(t_all)
    np.testing.assert_allclose(dt, 1 / 12000.0, rtol=1e-3)


def test_gps_week_wrap():
    tk = GnssTimekeeper(nominal_rate=12000)
    week = 7 * 24 * 3600
    # two frames just before the wrap, then wrapped values near 0
    tk.update(week - 1, 0, 512)
    tk.update(week - 1, int(512 / 12000 * 1e9), 512)
    t = tk.update(0, int((2 * 512 / 12000 - 1) * 1e9 % 1e9), 512)
    assert tk.rate > 0
    assert t is not None
    assert t[0] > week - 2  # time keeps increasing across the wrap


@pytest.mark.parametrize("true_rate,start", [(12010.0, 1000.0),
                                             (20250.3, 604799.5)])
def test_same_stamps_as_the_reference(true_rate, start):
    """A drifting 12 kHz stream, and a 20.25 kHz one across the GPS week
    wrap: equal rates and timestamps frame by frame."""
    week = 7 * 24 * 3600

    def frames():
        gps = start
        for _ in range(40):
            g = gps % week
            sec = int(g)
            yield sec, int((g - sec) * 1e9)
            gps += 512 / true_rate
    nominal = round(true_rate)
    port, ref = GnssTimekeeper(nominal), jgnss.GnssTimekeeper(nominal)
    for sec, nsec in frames():
        a, b = port.update(sec, nsec, 512), ref.update(sec, nsec, 512)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
        assert port.rate == ref.rate
    assert port.drift_ppm == ref.drift_ppm
