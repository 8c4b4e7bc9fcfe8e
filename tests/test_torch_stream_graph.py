"""The live monitor's held graph (`runtime/stream_graph.py`) on the CPU.

A CUDA graph runs only on a card, so here `GraphRunner` records and
replays through `StandIn`, a graph that records the chunk's body and
replays it by running it again eagerly into the recorded outputs (what a
graph's fixed buffers hold after a replay). At the smallest planar shape of
the CPU suite (512 channels, 512 frames, fast profile):

  * a default `MonitorCore` on the CPU stays eager, its audio, RSSI table
    and state those of `wideband.process_i16` bit for bit;
  * the runner's audio, RSSI and state equal the eager chunks' bit for bit,
    the state it returns is its own leaves, a foreign state is copied in,
    and parameters written in place or a new parameters object are
    recorded anew before the chunk runs;
  * it runs the eager function for complex input and a wrong chunk size,
    `wrap` builds none for a configuration off the planar tier, and a
    caller's process function is left as it is;
  * a replay adds the launches the recording made of each counted
    wrapper, an eager chunk adds none, and the recording's own count is
    put back;
  * it holds what the recorded chunk read that was made before it (the
    parameters, the plan's row orders) and none of its own intermediates;
  * `profiling.count_graph` records by chunk only under a profiler.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from supersdr_tpu_torch.apps.monitor import MonitorCore
from supersdr_tpu_torch.ops import cuda as cuda_ops
from supersdr_tpu_torch.ops import cx
from supersdr_tpu_torch.ops.cuda import chain_tail, channelize_fused
from supersdr_tpu_torch.runtime import stream_graph as sg
from supersdr_tpu_torch.runtime import wideband as twb
from supersdr_tpu_torch.utils import held, profiling

PLANAR = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
              taps_per=4, n_taps=129, mode="AM", **twb.PROFILES["fast"])
# what a recording of the card's chunk launches
CARD_CHUNK = {"channelize_fused": 1, "chain_tail": 1}


class StandIn:
    """A graph on the CPU: `capture` runs the body and keeps it (and
    counts CARD_CHUNK's launches, as a recording on the card does), and
    `replay` runs it again, its outputs copied into the recorded ones."""

    def __init__(self, device):
        self.device = device

    @staticmethod
    def records_on(device):
        return True

    def warm(self, body):
        body()

    def capture(self, body):
        wrappers = cuda_ops.counted()
        for name, n in CARD_CHUNK.items():
            wrappers[name].launches += n
        self.body = body
        self.out = body()
        return self.out

    def replay(self):
        for kept, new in zip(self.out, self.body()):
            kept.copy_(new)


@pytest.fixture(scope="module")
def stream():
    cfg = twb.WidebandConfig(**PLANAR)
    assert twb._planar_active(cfg)
    rng = np.random.default_rng(23)
    chunks = [tuple(rng.integers(-4000, 4000, cfg.chunk_in).astype(np.int16)
                    for _ in range(2)) for _ in range(4)]
    return cfg, chunks


def _eager(cfg):
    calls = []

    def fn(params, state, iq):
        calls.append(iq)
        if isinstance(iq, tuple) and not isinstance(iq, cx.CX):
            st, out = twb.process_i16(cfg, params, state, iq)
        else:
            st, out = twb.process(cfg, params, state, iq)
        return st, out.audio, out.rssi
    fn.calls = calls
    return fn


def _runner(cfg):
    params = twb.make_params(cfg, device="cpu")
    state = twb.init_state(cfg, device="cpu")
    eager = _eager(cfg)
    return sg.GraphRunner(cfg, params, state, eager, graph=StandIn), \
        params, state, eager


def _same_state(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(held.leaves(a),
                                                   held.leaves(b),
                                                   strict=True))


def test_a_default_monitor_on_the_cpu_stays_eager(stream):
    cfg, chunks = stream
    core = MonitorCore(cfg, thresh_db=-60.0, device="cpu")
    assert not isinstance(core.process_fn, sg.GraphRunner)
    params, state = core.params, twb.init_state(cfg, device="cpu")
    rows = np.full(cfg.n_chan, -120.0, np.float32)
    for c in chunks:
        core.push(c)
        state, out = twb.process_i16(cfg, params, state, c)
        rows = ((1.0 - core.ewma) * rows
                + core.ewma * out.rssi.float().mean(-1).numpy()
                ).astype(np.float32)
        assert torch.equal(core._last_audio, out.audio.T)
    assert np.array_equal(core.rssi_rows, rows)
    assert _same_state(core.state, state)


def test_the_runner_replays_the_eager_chunks_bit_for_bit(stream):
    cfg, chunks = stream
    runner, params, state, eager = _runner(cfg)
    eager_state = run_state = state
    for i, c in enumerate(chunks):
        if i == 2:      # a foreign state: the stream started anew
            run_state = twb.init_state(cfg, device="cpu")
            eager_state = twb.init_state(cfg, device="cpu")
        eager_state, audio, rssi = eager(params, eager_state, c)
        run_state, got_audio, got_rssi = runner(params, run_state, c)
        assert run_state is runner.state
        assert torch.equal(got_audio, audio) and torch.equal(got_rssi, rssi)
        assert _same_state(run_state, eager_state)
    assert len(eager.calls) == len(chunks)      # the runner's own: none


def test_parameters_written_or_new_are_recorded_before_the_chunk(stream):
    cfg, chunks = stream
    runner, params, state, eager = _runner(cfg)
    st_e = st_r = state
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for i, c in enumerate(chunks):
            if i == 1:                 # written in place
                params.chain.agc.target_db.copy_(
                    params.chain.agc.target_db - 6.0)
            if i == 2:                 # a new object
                params = params._replace(chain=params.chain._replace(
                    agc=params.chain.agc._replace(
                        target_db=params.chain.agc.target_db + 3.0)))
            with profiling.span("monitor.push"):
                st_e, audio, rssi = eager(params, st_e, c)
                st_r, got, got_rssi = runner(params, st_r, c)
            assert torch.equal(got, audio) and torch.equal(got_rssi, rssi)
            assert _same_state(st_r, st_e)
    assert list(profiling.graphs().values()) == [True, False, False, True]
    profiling.clear_spans()


@pytest.mark.parametrize("case", ["complex", "cx", "short"])
def test_the_eager_function_runs_where_no_graph_can(stream, case):
    cfg, chunks = stream
    runner, params, state, _ = _runner(cfg)
    calls = []
    runner.eager = lambda p, st, iq: calls.append(iq) or "eager"
    re, im = (torch.from_numpy(p.astype(np.float32) / 32768.0)
              for p in chunks[0])
    iq = {"complex": (re + 1j * im).numpy(), "cx": cx.CX(re, im),
          "short": tuple(p[:cfg.chunk_in // 2] for p in chunks[0])}[case]
    assert runner(params, state, iq) == "eager"
    assert len(calls) == 1 and calls[0] is iq


def test_a_callers_process_function_and_the_cpu_stay_eager(stream):
    cfg, _ = stream
    params = twb.make_params(cfg, device="cpu")

    def mine(p, st, iq):
        raise AssertionError("not called")
    core = MonitorCore(cfg, params=params, process_fn=mine)
    assert core.process_fn is mine
    eager = _eager(cfg)
    assert sg.wrap(cfg, params, twb.init_state(cfg, device="cpu"),
                   eager) is eager


@pytest.mark.parametrize("time_major", [True, False])
def test_wrap_builds_a_runner_only_on_the_planar_tier(stream, time_major):
    cfg, _ = stream
    cfg = dataclasses.replace(cfg, time_major=time_major)
    params = twb.make_params(cfg, device="cpu")
    state = twb.init_state(cfg, device="cpu")
    eager = _eager(cfg)
    got = sg.wrap(cfg, params, state, eager, graph=StandIn)
    planar = twb._plan(cfg, params.W_pfb.device).tier is twb._process_planar
    assert planar == time_major
    assert isinstance(got, sg.GraphRunner) if planar else got is eager


def test_a_replay_adds_the_recorded_launches_and_an_eager_chunk_none(
        stream):
    cfg, chunks = stream
    wrappers = cuda_ops.counted()
    before = {n: w.launches for n, w in wrappers.items()}
    runner, params, state, eager = _runner(cfg)
    # the recording launched nothing: its counts were put back
    assert {n: w.launches for n, w in wrappers.items()} == before
    st = state
    for k, c in enumerate(chunks[:3], 1):
        st, _, _ = runner(params, st, c)
        grew = {n: w.launches - before[n] for n, w in wrappers.items()}
        assert grew == {n: CARD_CHUNK.get(n, 0) * k for n in wrappers}
    re, im = (torch.from_numpy(p.astype(np.float32) / 32768.0)
              for p in chunks[3])
    runner(params, st, cx.CX(re, im))          # eager: counts itself
    assert channelize_fused.channelize_fused_raw3.launches \
        == before["channelize_fused"] + 3
    assert chain_tail.chain_tail_fir.launches == before["chain_tail"] + 3
    for n, w in wrappers.items():
        w.launches = before[n]


def test_the_runner_holds_what_the_recorded_chunk_read(stream):
    cfg, _ = stream
    runner, params, _, _ = _runner(cfg)
    plan = twb._plan(cfg, runner.device)
    held = {id(t) for t in runner._reads.values()}
    for t in (plan.order, plan.inv, params.W_pfb, params.chain.P_interp,
              params.chain.W_tailpass, *runner._planes):
        assert id(t) in held
    made = {id(t) for t in (*runner._out, *runner._leaves)}
    assert not made & held - {id(t) for t in runner._leaves}
    assert all(t.shape != runner._out[0].shape
               for t in runner._reads.values())


def test_count_graph_records_by_chunk_only_under_a_profiler():
    profiling.clear_spans()
    profiling.count_graph(True)
    assert profiling.graphs() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("monitor.push", 7):
            profiling.count_graph(True)
        with profiling.span("monitor.push", 8):
            profiling.count_graph(True)
            profiling.count_graph(False)
    assert profiling.graphs() == {7: True, 8: False}
    profiling.clear_spans()
    assert profiling.graphs() == {}
