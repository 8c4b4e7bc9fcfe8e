"""`plan_hit_pct.*` (`sdrbench/plan_hits.py`): the share of traced chunks
that found the program's plan held, on synthetic spans and plan records;
None where the program records spans but no plans (a version of the
program without the counter), or where no chunk recorded one.

    python3 -m pytest sdrbench/tests/test_sdrbench_plan_hits.py
"""

import pytest

from sdrbench import run as R
from sdrbench import spans
from sdrbench.trace import Trace
from supersdr_tpu_torch.utils import profiling

BASE = 1_790_857_026_123_456_789
METRICS = ("plan_hit_pct.replay", "plan_hit_pct.live")


def _spans(n: int) -> list:
    """n chunks, each a root span and one child."""
    out = []
    for k in range(n):
        t = BASE + k * 2_000_000
        out += [profiling.Span("wideband.process", t, t + 1_000_000, -1,
                               k + 1),
                profiling.Span("wideband.plan", t, t + 10_000, 2 * k, k + 1)]
    return out


def _read(metric, monkeypatch, sp, plans):
    monkeypatch.setattr(spans, "recorded",
                        lambda ctx: (sp, {}) if ctx["trace"] else None)
    if plans is None:
        monkeypatch.delattr(profiling, "plans")
    else:
        monkeypatch.setattr(profiling, "plans", lambda: dict(plans),
                            raising=False)
    trace = Trace(device=[], window_s=1.0, chunks=0, span_s=[])
    return R.metric_reader(metric)({"trace": trace, "conf": {}, "frames": 0,
                                    "dispatch_ms": None})


@pytest.mark.parametrize("metric", METRICS)
def test_the_share_of_chunks_that_found_their_plan_held(metric, monkeypatch):
    sp = _spans(4)
    assert _read(metric, monkeypatch, sp,
                 {1: False, 2: False, 3: False, 4: False}) == 100.0
    assert _read(metric, monkeypatch, sp,
                 {1: True, 2: False, 3: False, 4: False}) == 75.0
    # a chunk that recorded nothing did not find its plan held
    assert _read(metric, monkeypatch, sp, {1: False, 2: False}) == 50.0


@pytest.mark.parametrize("metric", METRICS)
def test_no_plan_records_no_reading(metric, monkeypatch):
    sp = _spans(3)
    assert _read(metric, monkeypatch, sp, None) is None     # the parent
    assert _read(metric, monkeypatch, sp, {}) is None
    assert _read(metric, monkeypatch, [], {1: False}) is None
