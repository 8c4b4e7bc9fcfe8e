"""The kernels' bytes and operations at HEADLINE (2560 channels, 16128
frames a chunk, 257 taps, ×4 to 48 kHz) against hand arithmetic."""

import json
import math

import pytest

from sdrbench import roofline
from sdrbench import run as R

FRAMES = 16128
N = 2560 * FRAMES            # complex samples a chunk


def conf(name):
    with open(R.BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name, plane, issue_mb", [
    ("hf2560_am_fast", 2, 330), ("hf2560_am_quality", 4, 495)])
def test_channelizer_counts(name, plane, issue_mb):
    b, f = roofline.kernel("channelize_fused").counts(conf(name), FRAMES)
    # sc16 in, history and taps in, planes out
    hand = N * 4 + 7 * 2560 * 8 + 8 * 2560 * 4 + N * 2 * plane
    assert b == hand
    assert abs(b / 1e6 - issue_mb) / issue_mb < 0.01
    assert f == 4 * 8 * N + 5 * 2560 * math.log2(2560) * FRAMES
    assert roofline.least_s(b, f) == b / roofline.PEAKS["hbm_bytes_s"]


@pytest.mark.parametrize("name, plane, issue_mb", [
    ("hf2560_am_fast", 2, 825), ("hf2560_am_quality", 4, 990)])
def test_tail_counts(name, plane, issue_mb):
    b, f = roofline.kernel("chain_tail_fir").counts(conf(name), FRAMES)
    # planes in; history (256 complex float32) and state (4 + 8 float32)
    # in and out; float32 audio (×4) and the RSSI out
    hand = (N * 2 * plane + 2 * 2560 * (256 * 8 + 12 * 4) + N * 4 * 4
            + 2560 * 4)
    assert b == hand
    # the issue's round figure leaves the history and state out
    assert abs(b / 1e6 - issue_mb) / issue_mb < 0.015
    assert f == (4 * 257 + 2 * 9 * 4) * N


def test_share_is_silent_without_launches():
    from sdrbench.trace import Trace
    tr = Trace(device=[], window_s=1.0, chunks=1, span_s=[])
    assert roofline.share_pct(tr, "chain_tail_fir", conf("hf2560_am_fast"),
                              FRAMES) is None
