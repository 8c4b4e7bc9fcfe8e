"""What a configuration file alone decides: the program's tier and its
further fields, the layout of its output rows and the kernels each chunk
launches; and the replay's draw of late chunks over the whole window."""

import math

import numpy as np
import pytest

from sdrbench import check, system
from sdrbench.drivers import replay
from sdrbench.tests import small

# configurations that no file of the benchmark holds, each run through a
# whole replay at the small size by its data alone
VARIANTS = {
    # the fast tier's kernels in the chan-major layout
    "fast_chanmajor": ("hf2560_am_fast.replay",
                       {"wideband": {"time_major": False},
                        "rows": "identity"}),
    # the chan-major tier: the fold kernel, an FFT, overlap-save, the
    # chain-major tail, in float32
    "chanmajor_tier": ("hf2560_am_quality.replay",
                       {"profile": None,
                        "wideband": {"time_major": False,
                                     "pallas_fold": True,
                                     "tail_impl": "pallas",
                                     "passband_impl": "fft"},
                        "rows": "identity",
                        "launches": {"pfb_fold.pfb_fold": 1,
                                     "chain_tail.chain_tail_am_c": 1}}),
    # the receiver's defaults: the MW band into 100 channels
    "defaults_100": ("hf2560_am_quality.replay",
                     {"profile": None, "wideband": {}, "rows": "identity",
                      "launches": {},
                      "deployment": {"n_chan": 100, "fs_in": 1_200_000}}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_a_configuration_is_data_alone(variant):
    name, update = VARIANTS[variant]
    result, _ = small.execute(small.cell(name, conf_update=update),
                              system.program)
    assert result["correct"], result["compared"]


def test_the_row_layout_is_the_configurations():
    """The chan-major rows read as planar ones are wrong."""
    name, update = VARIANTS["fast_chanmajor"]
    result, _ = small.execute(
        small.cell(name, conf_update=dict(update, rows="planar")),
        system.program)
    assert not result["correct"]


class _Counted:
    launches_per_chunk = {"a.x": 1, "b.y": 2}

    def __init__(self, after):
        self._after = after

    def launches(self):
        return self._after


@pytest.mark.parametrize("after, ok", [({"a.x": 3, "b.y": 16}, True),
                                       ({"a.x": 2, "b.y": 16}, False),
                                       ({"a.x": 3, "b.y": 17}, False)])
def test_every_counted_kernel_launches_as_often_as_the_file_says(after, ok):
    got, lines = check.launches(_Counted(after), {"a.x": 0, "b.y": 10}, 3)
    assert got is ok and lines


def test_nothing_counted_holds_nothing():
    assert check.launches(_Counted({}), None, 3) == (True, [])


def _drawn(seed, k, n):
    res = replay.Reservoir(k, np.random.default_rng(seed))
    slots = {}
    for j in range(n):
        s = res.slot(j)
        if s is not None:
            slots[s] = j
    return sorted(slots.values())


def test_late_chunks_are_drawn_over_the_whole_window():
    k, n, trials = 3, 40, 4000
    counts = np.zeros(n)
    for seed in range(trials):
        drawn = _drawn(seed, k, n)
        assert len(drawn) == k
        counts[drawn] += 1
    expect = trials * k / n
    # each chunk equally likely: within 5 standard deviations
    assert np.all(np.abs(counts - expect) < 5 * math.sqrt(expect))
    assert _drawn(7, k, n) == _drawn(7, k, n)


def test_late_chunks_reach_far_into_a_long_window():
    drawn = [_drawn(seed, 3, 10_000) for seed in range(50)]
    assert np.median([max(d) for d in drawn]) > 5_000
