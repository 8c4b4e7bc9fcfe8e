"""The squelched band's cell and the squelch gate's per-layer metrics:
the committed configuration and traffic run correct by their data alone
at the small size, and their control not; the gate's least bytes from
what it met against a hand count; the readers (`sdrbench/gate.py`,
`squelch_device_ms.replay_keyed`, `squelch_roofline_pct`) on synthetic
spans, gate counts and device events; and, on a card (skipped without
one), the gate span's markers in a CUDA-only device trace.

    python3 -m pytest sdrbench/tests/test_sdrbench_gate.py
"""

import json

import pytest
import torch

from sdrbench import gate, roofline, spans, system
from sdrbench import run as R
from sdrbench.roofline import squelch
from sdrbench.tests import small
from sdrbench.trace import Event, Trace
from supersdr_tpu_torch.utils import profiling

BASE = 1_790_857_026_123_456_789
MARK = f"void at::cuda::(anonymous namespace)::{profiling.MARKER_KERNEL}(long)"
TAIL = "void chain_tail_fir_kernel<2>(float*)"
OP = "void at::native::vectorized_elementwise_kernel<4>(int)"
FRAMES = 16128


def _conf():
    with open(R.BENCH / "configs" / "hf2560_am_squelch.json") as f:
        return json.load(f)


def test_the_committed_cell_is_data_alone():
    """The squelched band on keyed carriers as its files state it: the
    program correct, its control not."""
    cell = small.cell("hf2560_am_squelch.replay_keyed")
    result, _ = small.execute(cell, system.program)
    assert result["correct"], result["compared"]
    result, _ = small.execute(cell, system.Control)
    assert not result["correct"], result["compared"]


def test_squelch_counts():
    c = _conf()
    n = FRAMES * 4                       # float32 audio samples a channel
    assert squelch.audio_samples(c, FRAMES) == n
    # 150 settled open, 2400 settled shut, 10 moving: the moving read and
    # write their audio, the shut write zeros, the open move none; each
    # reads its RSSI and reads and writes its open state and its gain
    b, f = squelch.counts(c, FRAMES, 150, 2400, 10)
    assert b == 10 * n * 8 + 2400 * n * 4 + 2560 * (4 + 16)
    assert f == 0.0
    assert squelch.counts(c, FRAMES, 2560, 0, 0)[0] == 2560 * 20
    # a chunk of the keyed band: about 2,400 shut and 50 moving, 0.19 ms
    b, f = squelch.counts(c, FRAMES, 150, 2400, 50)
    assert roofline.least_s(b, f) * 1e3 == pytest.approx(0.19, rel=0.02)


def _spans(chunks):
    """Each chunk: `wideband.process` around `chain.tail.unpack` around
    the gate span."""
    out = []
    for k in range(chunks):
        t = BASE + k * 10_000_000
        first = len(out)
        out += [profiling.Span("wideband.process", t, t + 5_000_000, -1, k),
                profiling.Span("chain.tail.unpack", t + 1_000, t + 4_000_000,
                               first, k),
                profiling.Span(gate.SPAN, t + 2_000, t + 3_000_000,
                               first + 1, k)]
    return out


def _device(chunks, gate_us=(400.0, 500.0, 2000.0)):
    """Each chunk: the tail's kernel, one operation before the gate, the
    gate's operations between two markers, one after; µs."""
    dev, t = [], 0.0
    for _ in range(chunks):
        dev += [Event(TAIL, t, t + 900), Event(OP, t + 900, t + 950),
                Event(MARK, t + 950, t + 952)]
        t += 952
        for d in gate_us:
            dev.append(Event(OP, t, t + d))
            t += d
        dev += [Event(MARK, t, t + 2), Event(OP, t + 2, t + 30)]
        t += 100
    return dev


def _ctx(monkeypatch, sp, dev, counts):
    tr = Trace(device=dev, window_s=1.0, chunks=len(counts), span_s=[])
    monkeypatch.setattr(spans, "recorded",
                        lambda ctx: (sp, {}) if ctx["trace"] else None)
    monkeypatch.setattr(profiling, "gates", lambda: dict(counts))
    return {"trace": tr, "conf": _conf(), "frames": FRAMES,
            "dispatch_ms": None}


def test_gate_ops_are_those_between_each_spans_markers(monkeypatch):
    ctx = _ctx(monkeypatch, _spans(3), _device(3),
               {k: (150, 2400, 10) for k in range(3)})
    ops = gate.gate_ops(ctx)
    assert [len(g) for g in ops] == [3, 3, 3]
    assert all(e.name == OP for g in ops for e in g)
    assert R.metric_reader("squelch_device_ms.replay_keyed")(ctx) == \
        pytest.approx(2.9)
    assert gate.met(ctx) == (450, 7200, 30)


def test_roofline_share_from_the_counts_over_the_device_time(monkeypatch):
    counts = {0: (150, 2360, 50), 1: (140, 2370, 50)}
    ctx = _ctx(monkeypatch, _spans(2), _device(2), counts)
    b, f = squelch.counts(_conf(), FRAMES, 290, 4730, 100)
    want = 100.0 * roofline.least_s(b, f) / (2 * 2.9e-3)
    got = R.metric_reader("squelch_roofline_pct")(ctx)
    assert got == pytest.approx(want)
    # about 2,400 settled shut and 50 moving a chunk: the gate's least
    # time about 0.19 ms against its 2.9
    assert 6.0 < got < 7.0


@pytest.mark.parametrize("change", ["no_span", "odd_marker", "no_marker",
                                    "no_counts", "no_counter"])
def test_silent_where_the_program_or_trace_holds_no_gate(change,
                                                         monkeypatch):
    sp, dev = _spans(2), _device(2)
    counts = {0: (1, 2, 3), 1: (1, 2, 3)}
    if change == "no_span":
        sp = [s for s in sp if s.name != gate.SPAN]
    elif change == "odd_marker":
        dev = [e for i, e in enumerate(dev) if i != 2]
    elif change == "no_marker":
        monkeypatch.delattr(profiling, "MARKER_KERNEL")
    elif change == "no_counts":
        counts = {0: (1, 2, 3)}
    ctx = _ctx(monkeypatch, sp, dev, counts)
    if change == "no_counter":
        monkeypatch.delattr(profiling, "gates")
    pct = R.metric_reader("squelch_roofline_pct")(ctx)
    ms = R.metric_reader("squelch_device_ms.replay_keyed")(ctx)
    assert pct is None
    assert (ms is None) is (change not in ("no_counts", "no_counter"))


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_the_gate_spans_markers_bracket_its_operations_on_the_card(card):
    """Under CUDA activity alone, as the benchmark's tracer runs it, each
    device span's operations lie between its two markers and none
    outside."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from sdrbench import trace
    x = torch.ones(1 << 20, device="cuda")
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(3):
            with profiling.span("wideband.process"):
                x = x * 2.0
                with profiling.device_span(gate.SPAN, x):
                    x = x + 1.0
                    x = x.sqrt()
                profiling.count_gate(torch.ones(8, device="cuda"),
                                     torch.zeros(8, device="cuda"))
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    with open(path) as f:
        dev = trace.device_events(json.load(f)["traceEvents"])
    os.unlink(path)
    ctx = {"trace": Trace(device=dev, window_s=1.0, chunks=3, span_s=[]),
           "conf": _conf(), "frames": FRAMES, "dispatch_ms": None}
    ops = gate.gate_ops(ctx)
    assert ops is not None and [len(g) for g in ops] == [2, 2, 2]
    assert gate.met(ctx) == (0, 0, 24)
    profiling.clear_spans()
