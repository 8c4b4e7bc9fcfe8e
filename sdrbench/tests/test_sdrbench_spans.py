"""The arithmetic of the metrics that read the program's spans and host
syncs (`sdrbench/spans.py` and its metric files), on synthetic spans and
device events; and, on a card (skipped without one), the profiler's gate
under CUDA activity alone and the live cell's spans on the device trace's
clock.

    python3 -m pytest sdrbench/tests/test_sdrbench_spans.py
"""

import json
import statistics
import subprocess
import sys

import pytest
import torch

from sdrbench import run as R
from sdrbench import spans
from sdrbench.trace import Event, Trace
from supersdr_tpu_torch.utils import profiling

BASE = 1_790_857_026_123_456_789          # the trace's base, Unix ns
CHAN = "void channelize_mma_kernel<1>(float*)"
TAIL = "void chain_tail_fir_kernel<2>(float*)"


def _chunk_spans(t0: float, chunk: int, first: int) -> list:
    """One replay chunk's spans at t0 µs on the trace's clock, indices
    from `first`: [name, start µs, end µs, parent offset or None]."""
    rows = [("wideband.process", 0, 1000, None),
            ("wideband.ingest", 0, 50, 0), ("wideband.plan", 50, 100, 0),
            ("wideband.channelize", 100, 150, 0),
            ("wideband.history", 150, 200, 0),
            ("chain.tail", 200, 1000, 0), ("chain.tail.pack", 200, 590, 5),
            ("chain.tail.launch", 590, 610, 5),
            ("chain.tail.unpack", 610, 1000, 5)]
    return [profiling.Span(n, BASE + int((t0 + a) * 1e3),
                           BASE + int((t0 + b) * 1e3),
                           -1 if p is None else first + p, chunk)
            for n, a, b, p in rows]


def _replay(latency_us: float = 0.0):
    """Two chunks 1100 µs apart; each launches the channelizer at 100 µs
    (it runs to 400) and the tail at 590 µs (it runs 600-900)."""
    sp = _chunk_spans(0.0, 1, 0) + _chunk_spans(1100.0, 2, 9)
    dev = []
    for t0 in (0.0, 1100.0):
        dev += [Event(CHAN, t0 + 100 + latency_us, t0 + 400),
                Event(TAIL, t0 + 600, t0 + 900)]
    return sp, dev


def test_the_base_is_the_latest_launch_less_its_kernels_start():
    sp, dev = _replay(latency_us=5.0)
    # the tail's kernel starts 10 µs after its launch span, the
    # channelizer's 5: the base is placed 5 µs early
    assert spans.base_ns(sp, dev) == BASE - 5000
    sp0, dev0 = _replay()
    assert spans.base_ns(sp0, dev0) == BASE
    assert spans.base_ns(sp0, dev0[:-1]) is None      # a launch unpaired
    assert spans.base_ns(sp0, []) is None


def test_each_chunks_fetches_bound_its_own_base():
    """A live chunk's two fetches each copy one tensor to the host, 3 and
    2 µs after their spans begin, against 40 µs for its launch; the
    second chunk's clock runs 700 µs behind the first's (the trace's clock
    wanders against the host's over a long window)."""
    sp = _live()
    drift = {1: 0.0, 2: 700.0, 3: 700.0}
    dev = []
    for s in sp:
        t = (s.start_ns - BASE) * 1e-3 + drift[s.chunk]
        if s.name == "monitor.rssi_fetch":
            dev.append(Event("Memcpy DtoH (Device -> Pinned)", t + 3, t + 9))
        elif s.name == "monitor.audio_fetch":
            dev.append(Event("Memcpy DtoH (Device -> Pageable)", t + 2,
                             t + 5))
        elif s.name == "wideband.ingest":
            dev.append(Event(CHAN, t + 40, t + 100))
    dev.sort(key=lambda e: e.start)
    sp = sp + [profiling.Span("wideband.channelize", s.start_ns, s.end_ns,
                              s.parent, s.chunk)
               for s in sp if s.name == "wideband.ingest"]
    want = {c: BASE - 2000 - int(drift[c] * 1e3) for c in drift}
    assert spans.chunk_bases(sp, dev) == want
    assert spans.clock(sp, dev) == want
    # one base for the window: the first chunk's, 700 µs off the others'
    assert spans.base_ns(sp, dev) == BASE - 40_000
    # without the copies, each chunk's launch alone
    no_copies = [e for e in dev if "DtoH" not in e.name]
    assert spans.chunk_bases(sp, no_copies) == {
        c: BASE - 40_000 - int(drift[c] * 1e3) for c in drift}
    # a copy missing from the trace: its chunk keeps its launch's bound
    first_rssi = next(e for e in dev if "Pinned" in e.name)
    got = spans.chunk_bases(sp, [e for e in dev if e is not first_rssi])
    assert got == {**want, 1: BASE - 40_000}


def test_idle_inside_the_program_and_split_by_the_innermost_span():
    sp, dev = _replay()
    roots = [s for s in sp if s.name == "wideband.process"]
    # each chunk: 1000 µs in the program, 600 of them busy
    assert spans.idle_in_s(roots, BASE, dev) == pytest.approx(800e-6)
    split = spans.idle_by_span(sp, BASE, dev, window_s=2.3e-3)
    want = {"wideband.ingest": 100e-6, "wideband.plan": 100e-6,
            "chain.tail.pack": 380e-6, "chain.tail.launch": 20e-6,
            "chain.tail.unpack": 200e-6, "outside the program": 100e-6,
            "slice ends": 200e-6}
    for name, v in split.items():
        assert v == pytest.approx(want.get(name, 0.0), abs=1e-12), name
    # the split adds up to the slice's idle time
    busy = sum(e.end - e.start for e in dev) * 1e-6
    assert sum(split.values()) == pytest.approx(2.3e-3 - busy)


def test_self_times_a_chunk_by_span():
    sp, _ = _replay()
    t = spans.self_ms_by_name(sp)
    assert t["wideband.process"] == pytest.approx(0.0, abs=1e-12)
    assert t["chain.tail"] == pytest.approx(0.0, abs=1e-12)
    assert t["chain.tail.pack"] == pytest.approx(0.39)
    assert t["wideband.channelize"] == pytest.approx(0.05)
    assert sum(t.values()) == pytest.approx(1.0)


def _live() -> list:
    """Three live chunks: a push with the receiver inside, then the fetch
    of the listened row; chunk 2's push takes 0.5 ms longer."""
    out = []
    for k, t0 in enumerate((0.0, 10_000.0, 20_000.0)):
        extra = 500 if k == 1 else 0
        rows = [("monitor.push", 0, 2000 + extra, None),
                ("monitor.process", 0, 1500 + extra, 0),
                ("wideband.process", 0, 1500 + extra, 1),
                ("wideband.ingest", 0, 150, 2),
                ("monitor.rssi_fetch", 1600 + extra, 1900 + extra, 0),
                ("monitor.selected_audio", 2000 + extra, 2100 + extra, None),
                ("monitor.audio_fetch", 2020 + extra, 2080 + extra, 5)]
        first = len(out)
        out += [profiling.Span(n, BASE + int((t0 + a) * 1e3),
                               BASE + int((t0 + b) * 1e3),
                               -1 if p is None else first + p, k + 1)
                for n, a, b, p in rows]
    return out


def _read(metric, monkeypatch, sp, syncs, trace=None):
    trace = trace or Trace(device=[], window_s=1.0, chunks=0, span_s=[])
    monkeypatch.setattr(spans, "recorded",
                        lambda ctx: (sp, syncs) if ctx["trace"] else None)
    return R.metric_reader(metric)({"trace": trace, "conf": {}, "frames": 0,
                                    "dispatch_ms": None})


def test_live_medians_split_issue_from_wait(monkeypatch):
    sp = _live()
    # each chunk: 2.1 ms (2.6 for chunk 2) in push and fetch; waits 0.51
    assert _read("host_issue_ms_p50.live", monkeypatch, sp, {}) == \
        pytest.approx(1.59)
    assert _read("host_wait_ms_p50.live", monkeypatch, sp, {}) == \
        pytest.approx(0.51)
    issue = spans.ms_by_chunk(sp, ("monitor.push", "monitor.selected_audio"))
    assert sorted(issue.values()) == pytest.approx([2.1, 2.1, 2.6])


def test_replay_metrics_on_synthetic_spans(monkeypatch):
    sp, dev = _replay()
    tr = Trace(device=dev, window_s=2.3e-3, chunks=2, span_s=[])
    assert _read("program_host_ms.replay", monkeypatch, sp, {}, tr) == \
        pytest.approx(1.0)
    assert _read("idle_in_program_pct.replay", monkeypatch, sp, {}, tr) == \
        pytest.approx(100 * 800e-6 / 2.3e-3)
    # no launch pairs: no reading
    tr0 = Trace(device=dev[:1], window_s=2.3e-3, chunks=2, span_s=[])
    assert _read("idle_in_program_pct.replay", monkeypatch, sp, {},
                 tr0) is None


def test_host_syncs_holds_only_where_every_chunk_agrees(monkeypatch):
    sp = _live()
    for metric in ("host_syncs.live", "host_syncs.replay"):
        assert _read(metric, monkeypatch, sp, {1: 4, 2: 4, 3: 4}) == 4
        assert _read(metric, monkeypatch, sp, {1: 4, 2: 3, 3: 4}) is None
        assert _read(metric, monkeypatch, sp, {1: 4, 3: 4}) is None
        assert _read(metric, monkeypatch, sp, {}) == 0


def test_no_spans_no_reading():
    profiling.clear_spans()
    tr = Trace(device=[Event(CHAN, 0, 1)], window_s=1.0, chunks=1,
               span_s=[])
    assert spans.recorded({"trace": tr}) is None
    assert spans.recorded({"trace": None}) is None


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_the_gate_is_on_under_cuda_activity_alone(card):
    from torch.profiler import ProfilerActivity, profile
    assert not profiling.recording()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert profiling.recording()
        with profiling.span("wideband.process"):
            torch.ones(8, device="cuda").sum()
    assert not profiling.recording()
    assert [s.name for s in profiling.spans()][-1] == "wideband.process"


def test_live_spans_lie_on_the_device_traces_clock(card, tmp_path):
    """A short traced run of the live cell, written by `python -m
    sdrbench.spans` as the benchmark runs it (its own process, pinned to
    one core). Each chunk shifted by its own base (`chunk_bases`, from its
    launches and its fetches' copies, every one found): the two input
    copies of ≥ 99 % of the chunks lie inside their `wideband.ingest`
    span (±20 µs), every counted kernel starts after its launch span
    began, and the program's spans cover ≥ 90 % of the driver's
    push-to-fetch span for the median chunk."""
    out = tmp_path / "live.json"
    run = subprocess.run(
        [sys.executable, "-m", "sdrbench.spans", "--workload",
         "hf2560_am_fast.live", "--seed", str(2 ** 31 + 107), "--seconds",
         "5", "--out", str(out)], cwd=R.ROOT, capture_output=True,
        text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    d = json.loads(out.read_text())
    assert d["correct"]
    sp = [profiling.Span(*s) for s in d["spans"]]
    dev = [Event(*e) for e in d["device"]]
    assert isinstance(d["base_ns"], dict), [(len(c), len(k)) for c, k in
                                            spans.launched(sp, dev)]
    base = {int(c): b for c, b in d["base_ns"].items()}
    assert len(spans.fetched(sp, dev, base)) == 2 * d["chunks"]
    ingest = [spans.shifted_us(s, base) for s in sp
              if s.name == "wideband.ingest"]
    h2d = [e for e in dev if "HtoD" in e.name]
    assert len(h2d) == 2 * len(ingest) == 2 * d["chunks"]
    inside = [all(a - 20 <= e.start and e.end <= b + 20
                  for e in h2d[2 * k:2 * k + 2])
              for k, (a, b) in enumerate(ingest)]
    # a chunk that straddles a step of the trace's clock (3.5 ms, once in
    # 703 chunks on the card) is the exception
    assert sum(inside) >= 0.99 * len(inside), inside.index(False)
    pairs = [p for c, k in spans.launched(sp, dev) for p in zip(c, k)]
    for s, e in pairs:
        assert e.start >= spans.shifted_us(s, base)[0] - 1e-3, (s, e)
    covered = spans.ms_by_chunk(sp, ("monitor.push",
                                     "monitor.selected_audio"))
    cover = [covered[c] / (t * 1e3)
             for c, t in zip(sorted(covered), d["span_s"])]
    assert statistics.median(cover) >= 0.9
    assert d["metrics"]["host_syncs.live"] == 4
