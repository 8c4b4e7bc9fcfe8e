"""`graph_replay_pct.live`: the share of traced chunks that replayed the
program's held graph, on synthetic spans and graph records; None where the
program records spans but no graphs (a version of the program without the
counter), or where no chunk recorded one.

    python3 -m pytest sdrbench/tests/test_sdrbench_graph_replay.py
"""

from sdrbench import run as R
from sdrbench import spans
from sdrbench.trace import Trace
from supersdr_tpu_torch.utils import profiling

BASE = 1_790_857_026_123_456_789
METRIC = "graph_replay_pct.live"


def _spans(n: int) -> list:
    """n chunks, each a push with its process call, and the fetch."""
    out = []
    for k in range(n):
        t = BASE + k * 2_000_000
        out += [profiling.Span("monitor.push", t, t + 1_000_000, -1, k + 1),
                profiling.Span("monitor.process", t, t + 500_000, 3 * k,
                               k + 1),
                profiling.Span("monitor.selected_audio", t + 1_000_000,
                               t + 1_100_000, -1, k + 1)]
    return out


def _read(monkeypatch, sp, graphs):
    monkeypatch.setattr(spans, "recorded",
                        lambda ctx: (sp, {}) if ctx["trace"] else None)
    if graphs is None:
        monkeypatch.delattr(profiling, "graphs")
    else:
        monkeypatch.setattr(profiling, "graphs", lambda: dict(graphs),
                            raising=False)
    trace = Trace(device=[], window_s=1.0, chunks=0, span_s=[])
    return R.metric_reader(METRIC)({"trace": trace, "conf": {}, "frames": 0,
                                    "dispatch_ms": None})


def test_every_chunk_replayed_reads_100(monkeypatch):
    assert _read(monkeypatch, _spans(4),
                 {1: True, 2: True, 3: True, 4: True}) == 100.0


def test_the_share_of_chunks_that_replayed(monkeypatch):
    sp = _spans(4)
    assert _read(monkeypatch, sp,
                 {1: False, 2: True, 3: True, 4: True}) == 75.0
    # a chunk that recorded nothing did not replay
    assert _read(monkeypatch, sp, {1: True, 2: True}) == 50.0


def test_no_graph_records_no_reading(monkeypatch):
    sp = _spans(3)
    assert _read(monkeypatch, sp, None) is None     # the parent
    assert _read(monkeypatch, sp, {}) is None       # an eager process fn
    assert _read(monkeypatch, [], {1: True}) is None
    monkeypatch.setattr(spans, "recorded", lambda ctx: None)
    assert R.metric_reader(METRIC)({"trace": None}) is None
