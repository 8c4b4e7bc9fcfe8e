"""The program's spans and host-sync counter (`utils/profiling.span`,
`count_sync`), on the CPU.

Nothing is recorded without a running profiler. Under one, a chunk of
each wideband tier records its fixed span tree (one chunk identifier,
each span inside its parent, self times that add up to the root), the
monitor's push and the fetch after it share a chunk, and the outputs are
bit for bit those of an unprofiled run. `profiling.trace` writes the
spans into its Chrome trace on the clock of the trace's own events: the
channelizer's FFTs lie inside the `wideband.channelize` span. Every test
empties the recorder first (test files run side by side in one process
pool, and the recorder is the process's).
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from supersdr_tpu_torch.apps.monitor import MonitorCore
from supersdr_tpu_torch.runtime import wideband as wb
from supersdr_tpu_torch.utils import profiling

PLANAR = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
              taps_per=4, n_taps=129, mode="AM", **wb.PROFILES["fast"])
TMAJOR = dict(PLANAR, chunk_in=512 * 264)        # frames % chan_tile_t ≠ 0
SMALL = dict(fs_in=192_000, n_chan=16, chunk_in=32_768, taps_per=8,
             n_taps=129, mode="AM")
CHANMAJOR = dict(SMALL, passband_impl="matmul")  # FFTs: the channelizer's
FALLBACK = dict(SMALL, time_major=True)          # 16 channels: not fused

TAIL = {"chain.tail": "wideband.process",
        "chain.tail.pack": "chain.tail",
        "chain.tail.launch": "chain.tail",
        "chain.tail.unpack": "chain.tail"}
FUSED = dict({"wideband.process": None, "wideband.ingest": "wideband.process",
              "wideband.plan": "wideband.process",
              "wideband.channelize": "wideband.process",
              "wideband.history": "wideband.process"}, **TAIL)
UNFUSED = {"wideband.process": None, "wideband.ingest": "wideband.process",
           "wideband.plan": "wideband.process",
           "wideband.channelize": "wideband.process",
           "chain.process": "wideband.process"}


GATED = dict(squelch_enabled=True)
SQUELCH = dict(enabled=True, thresh_db=-70.0, hyst_db=6.0, ramp_samples=240)


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _i16(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(-3000, 3000, cfg.chunk_in).astype(np.int16)
                 for _ in range(2))


def _chunk(kw, seed=0, squelch=SQUELCH):
    cfg = wb.WidebandConfig(**kw)
    params = wb.make_params(cfg, device="cpu", squelch_kwargs=squelch
                            if cfg.squelch_enabled else None)
    state = wb.init_state(cfg, device="cpu")
    return cfg, params, state, _i16(cfg, seed)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def test_nothing_is_recorded_without_a_profiler():
    cfg, params, state, iq = _chunk(PLANAR)
    wb.process_i16(cfg, params, state, iq)
    core = MonitorCore(cfg, params=params)
    core.push(iq)
    core.selected_audio()
    assert not profiling.recording()
    assert profiling.spans() == [] and profiling.host_syncs() == {}


@pytest.mark.parametrize("kw, tree", [(PLANAR, FUSED), (TMAJOR, FUSED),
                                      (CHANMAJOR, UNFUSED),
                                      (FALLBACK, UNFUSED)],
                         ids=["planar", "tmajor", "chanmajor", "fallback"])
def test_a_chunk_records_its_tiers_span_tree(kw, tree):
    cfg, params, state, iq = _chunk(kw)
    _profiled(lambda: wb.process_i16(cfg, params, state, iq))
    sp = profiling.spans()
    names = [s.name for s in sp]
    assert sorted(names) == sorted(tree)
    assert names[0] == "wideband.process" and sp[0].parent == -1
    for s in sp:
        parent = tree[s.name]
        assert (s.parent == -1) if parent is None \
            else sp[s.parent].name == parent
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert {s.chunk for s in sp} == {sp[0].chunk}
    kids = [[c for c in sp if c.parent == i] for i in range(len(sp))]
    self_ns = [s.end_ns - s.start_ns - sum(c.end_ns - c.start_ns
                                           for c in kids[i])
               for i, s in enumerate(sp)]
    assert min(self_ns) >= 0
    assert sum(self_ns) == sp[0].end_ns - sp[0].start_ns
    # the planar and time-major tiers, in the order the host runs them
    top = [s.name for s in sp if s.parent == 0]
    assert top[:3] == ["wideband.ingest", "wideband.plan",
                       "wideband.channelize"]
    assert profiling.host_syncs() == {}        # input and params on the host


def test_push_and_its_fetch_share_a_chunk_and_the_next_push_starts_one():
    cfg, params, _, iq = _chunk(PLANAR)
    core = MonitorCore(cfg, params=params)

    def run():
        core.push(iq)
        core.selected_audio()
        core.push(iq)
    _profiled(run)
    sp = profiling.spans()
    roots = [(s.name, s.chunk) for s in sp if s.parent == -1]
    assert [n for n, _ in roots] == ["monitor.push", "monitor.selected_audio",
                                     "monitor.push"]
    assert roots[0][1] == roots[1][1] != roots[2][1]
    push = [i for i, s in enumerate(sp) if s.name == "monitor.push"][0]
    kids = [s.name for s in sp if s.parent == push]
    assert kids == ["monitor.process", "monitor.rssi_fetch"]
    proc = [i for i, s in enumerate(sp) if s.name == "monitor.process"][0]
    assert [s.name for s in sp if s.parent == proc] == ["wideband.process"]
    fetch = [s for s in sp if s.name == "monitor.audio_fetch"]
    assert len(fetch) == 1 and sp[fetch[0].parent].name == \
        "monitor.selected_audio"


@pytest.mark.parametrize("kw", [PLANAR, CHANMAJOR, dict(PLANAR, **GATED)],
                         ids=["planar", "chanmajor", "planar_squelch"])
def test_outputs_are_bit_for_bit_with_the_profiler_on(kw):
    cfg, params, state, iq = _chunk(kw, seed=3)
    off = []
    st = state
    for _ in range(2):
        st, out = wb.process_i16(cfg, params, st, iq)
        off.append((out.audio, out.rssi, st))
    on = []

    def run():
        st = state
        for _ in range(2):
            st, out = wb.process_i16(cfg, params, st, iq)
            on.append((out.audio, out.rssi, st))
    _profiled(run)
    assert len(profiling.spans()) > 0
    for (a0, r0, s0), (a1, r1, s1) in zip(off, on):
        assert torch.equal(a0, a1) and torch.equal(r0, r1)
        for x, y in zip(torch.utils._pytree.tree_leaves(s0),
                        torch.utils._pytree.tree_leaves(s1)):
            assert torch.equal(x, y)


def test_host_syncs_count_each_crossing_of_a_card(monkeypatch):
    """`coerce` counts a plane that is not on the params' card, the
    monitor a fetch from a card; a CPU run crosses nothing. (A stand-in
    device type: this machine has no card.)"""
    cuda = torch.device("cuda", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("wideband.ingest"):
            wb._count_crossings((np.zeros(4, np.int16),
                                 torch.zeros(4, dtype=torch.int16)), cuda)
            wb._count_crossings((torch.zeros(4),), torch.device("cpu"))
        chunk = profiling.spans()[0].chunk
        with profiling.span("monitor.rssi_fetch"):
            MonitorCore._host(torch.zeros(4))
    assert profiling.host_syncs() == {chunk: 2}


def test_trace_writes_the_spans_on_its_own_clock(tmp_path):
    """The spans land in `trace`'s Chrome trace as `program_span` events,
    converted with the file's `baseTimeNanoseconds`: every FFT of the
    chunk (the channelizer's alone: the passband is the matmul one) lies
    inside the `wideband.channelize` span, within 50 µs, and none inside
    `chain.process`."""
    cfg, params, state, iq = _chunk(CHANMAJOR)
    wb.process_i16(cfg, params, state, iq)          # warm
    with profiling.trace(str(tmp_path)):
        wb.process_i16(cfg, params, state, iq)
    (path,) = profiling.trace_files(str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == profiling.SPAN_CATEGORY}
    assert set(spans) == set(UNFUSED)
    ch, tail = spans["wideband.channelize"], spans["chain.process"]
    ffts = [e for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("aten::") and "fft" in e["name"]]
    assert ffts
    for e in ffts:
        assert ch["ts"] - 50 <= e["ts"]
        assert e["ts"] + e["dur"] <= ch["ts"] + ch["dur"] + 50
        assert not tail["ts"] <= e["ts"] <= tail["ts"] + tail["dur"]
    assert spans["wideband.process"]["args"]["parent"] == -1


@pytest.mark.parametrize("kw, parent", [
    (PLANAR, "chain.tail.unpack"), (TMAJOR, "chain.tail.unpack"),
    (CHANMAJOR, "chain.process"), (FALLBACK, "chain.process")],
    ids=["planar", "tmajor", "chanmajor", "fallback"])
def test_the_gate_has_a_span_of_its_own_once_a_chunk(kw, parent):
    cfg, params, state, iq = _chunk(dict(kw, **GATED))

    def run():
        st = state
        for _ in range(2):
            st, _ = wb.process_i16(cfg, params, st, iq)
    _profiled(run)
    sp = profiling.spans()
    gate = [s for s in sp if s.name == "chain.tail.squelch"]
    roots = [s.chunk for s in sp if s.parent == -1]
    assert sorted(s.chunk for s in gate) == sorted(roots) and len(roots) == 2
    for s in gate:
        p = sp[s.parent]
        assert p.name == parent
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert profiling.host_syncs() == {}


def _gate_counts(gain_in, open_out):
    shut = int(((gain_in == 0) & (open_out == 0)).sum())
    open_ = int(((gain_in == 1) & (open_out == 1)).sum())
    return (open_, shut, gain_in.numel() - open_ - shut)


# (tier, an open threshold a few dB under the RSSI of its loud chunks)
@pytest.mark.parametrize("kw, thresh_db", [(PLANAR, -70.0),
                                           (CHANMAJOR, -54.0)],
                         ids=["planar", "chanmajor"])
def test_gate_counts_add_up_to_the_channels_and_follow_the_state(
        kw, thresh_db):
    """Each chunk's three counts are those of the gain the gate entered
    with and the gate it decided (the state before and after the chunk),
    and add up to the channels."""
    cfg, params, state, _ = _chunk(dict(kw, **GATED),
                                   squelch=dict(SQUELCH, thresh_db=thresh_db))
    want, chunks = [], []

    def run():
        st = state
        # quiet, quiet, loud, loud: gates shut (moving), stay shut, open
        # (moving), stay open
        for seed, scale in enumerate((100, 100, 1, 1)):
            iq = tuple((x // scale).astype(np.int16)
                       for x in _i16(cfg, seed))
            before = st.chain.squelch
            st, _ = wb.process_i16(cfg, params, st, iq)
            want.append(_gate_counts(before.gain, st.chain.squelch.open_))
            chunks.append(profiling.spans()[-1].chunk)
    _profiled(run)
    got = profiling.gates()
    assert [got[c] for c in chunks] == want
    assert all(sum(n) == cfg.n_chan for n in want)
    n = cfg.n_chan
    assert want == [(0, 0, n), (0, n, 0), (0, 0, n), (n, 0, 0)]
    profiling.clear_spans()
    assert profiling.gates() == {}


def _on_a_card():
    """A stand-in for a tensor on a card: this machine has none."""
    class OnACard:
        device = torch.device("cuda", 0)
    return OnACard()


def test_nothing_is_recorded_or_marked_off_a_profiler(monkeypatch):
    marks = []
    monkeypatch.setattr(profiling, "_mark", marks.append)
    cfg, params, state, iq = _chunk(dict(PLANAR, **GATED))
    wb.process_i16(cfg, params, state, iq)
    with profiling.device_span("chain.tail.squelch", _on_a_card()):
        pass
    profiling.count_gate(torch.ones(4), torch.ones(4))
    assert profiling.spans() == [] and profiling.host_syncs() == {}
    assert profiling.gates() == {} and marks == []


def test_a_device_span_marks_its_ends_on_a_card_alone(monkeypatch):
    """Under a profiler a device span on a card launches a marker as it
    opens and as it closes, inside the span; on the CPU none. (Stand-ins
    for the tensor and the launch: this machine has no card.)"""
    marks = []
    monkeypatch.setattr(profiling, "_mark", lambda d: marks.append(
        (d, len(profiling.spans()), profiling.spans()[-1].end_ns)))
    cuda = torch.device("cuda", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("chain.tail.unpack"):
            with profiling.device_span("chain.tail.squelch", _on_a_card()):
                pass
            with profiling.device_span("chain.tail.squelch", torch.ones(1)):
                pass
    sp = profiling.spans()
    assert [s.name for s in sp] == ["chain.tail.unpack",
                                    "chain.tail.squelch",
                                    "chain.tail.squelch"]
    assert sp[1].parent == sp[2].parent == 0
    # both marks while the first gate span was open
    assert marks == [(cuda, 2, None), (cuda, 2, None)]
