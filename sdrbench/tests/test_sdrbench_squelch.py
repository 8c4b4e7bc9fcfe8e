"""The squelch gate in the harness: the reference's gate alone (its
hysteresis, its ramp, blocks of chunks); the port's gate against it; a
whole replay at the small size with a `squelch` block, on steady and on
keyed carriers, where the sound program is correct and the control and
six faults of the gate are not; one channel's wrong decision, which the
gate's state alone fails; the edge rule, where a channel's RSSI lies
within the cell's `rssi_err_db` limit of a threshold; and the
configurations without a block, which the gate's code leaves as they
were."""

import copy
import json
import re

import numpy as np
import pytest
import torch

from sdrbench import check, signal, system
from sdrbench import run as R
from sdrbench.programs import wideband as wb_prog
from sdrbench.reference import modes, pipeline, squelch
from sdrbench.tests import small
from supersdr_tpu_torch.ops import squelch as squelch_ops

# between the noise channels (about −72 dB at the small size) and most
# carriers (up to about −47 dB): noise closes, and carriers between −68
# and −62 dB are held by the hysteresis
SQ = {"thresh_db": -62.0, "hyst_db": 6.0, "ramp_samples": 240}
# half the carriers sound two chunks of the ring's four and are silent two,
# so gates shut and open again through the window
KEYING = {"share": 0.5, "period_chunks": 4, "on_chunks": 2}
CELL = "hf2560_am_fast.replay"


def _dep(name="hf2560_am_fast", n_chan=256, **update):
    with open(R.BENCH / "configs" / f"{name}.json") as f:
        dep = json.load(f)["deployment"]
    dep.update(n_chan=n_chan, fs_in=n_chan * 12000, **update)
    return dep


def _iq(n_chan, frames, chunks, seed=1):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randint(-3000, 3000, (chunks * n_chan * frames,),
                               generator=g, dtype=torch.int16)
                 for _ in range(2))


def _gate(open_, gain):
    f = dict(dtype=torch.float64)
    return {"squelch.open_": torch.tensor(open_, **f),
            "squelch.gain": torch.tensor(gain, **f)}


# ---- the reference's gate alone

@pytest.mark.parametrize("open_, rssi, after", [
    (0.0, -62.0, 1.0),      # opens at the threshold
    (0.0, -62.5, 0.0),      # shut below it
    (1.0, -62.5, 1.0),      # held between the two thresholds
    (1.0, -68.0, 1.0),      # held at the close threshold
    (1.0, -68.5, 0.0),      # shuts below thresh − hyst
    (0.0, -68.5, 0.0),
    (1.0, -40.0, 1.0),
])
def test_gate_opens_at_thresh_and_closes_below_thresh_less_hyst(
        open_, rssi, after):
    t = squelch.tables(SQ, 4)
    got = squelch.decide(t, torch.tensor([open_], dtype=torch.float64),
                         torch.tensor([rssi], dtype=torch.float64))
    assert got.tolist() == [after]


@pytest.mark.parametrize("g0, rssi, n", [(1.0, -80.0, 2048),
                                         (1.0, -80.0, 500),
                                         (0.25, -50.0, 2048),
                                         (0.25, -50.0, 300),
                                         (1.0, -50.0, 100)])
def test_ramp_closed_form_and_carried_gain(g0, rssi, n):
    L = 4
    t = squelch.tables(SQ, L)
    audio = torch.ones(1, n, dtype=torch.float64)
    open0 = float(g0 > 0.5)
    out, leaves, made = squelch.apply(
        t, audio, torch.tensor([[rssi]], dtype=torch.float64),
        _gate([open0], [g0]))
    target = 1.0 if rssi >= SQ["thresh_db"] else 0.0
    s = np.arange(1, n + 1)
    step = s / (SQ["ramp_samples"] * L)
    want = np.clip(g0 - step, 0.0, g0) if target == 0.0 \
        else np.clip(g0 + step, g0, 1.0)
    np.testing.assert_allclose(out[0].numpy(), want, rtol=0, atol=1e-15)
    assert leaves["squelch.open_"].tolist() == [target]
    assert leaves["squelch.gain"].item() == pytest.approx(want[-1],
                                                          abs=1e-15)
    assert made == squelch.Decisions(
        0, min(abs(rssi + 62.0), abs(rssi + 68.0)), int(target > open0),
        int(target < open0))


def test_four_chunk_block_equals_four_one_chunk_steps():
    M, frames = 256, 128
    re, im = _iq(M, frames, 4)
    t = pipeline.make_tables(_dep(), "cpu")
    one = pipeline.step(t, pipeline.zero_state(t, "cpu"), re, im, frames)
    # thresholds among the channels' RSSI, so that some shut, some open
    # and some decide at an edge
    med = float(one.rssi.median())
    t = pipeline.make_tables(
        _dep(squelch=dict(SQ, thresh_db=med + 0.1, hyst_db=0.3)), "cpu")
    # a system's RSSI beside the reference's, to take the edges' decisions
    g = torch.Generator().manual_seed(2)
    sys_rssi = one.rssi + 0.3 * torch.randn(one.rssi.shape, generator=g,
                                            dtype=torch.float64)
    block = pipeline.step(t, pipeline.zero_state(t, "cpu"), re, im, frames,
                          edge_rssi=sys_rssi, margin=0.36)
    st, audio, rssi = pipeline.zero_state(t, "cpu"), [], []
    made = squelch.NONE
    n = M * frames
    for k in range(4):
        s = pipeline.step(t, st, re[k * n:(k + 1) * n],
                          im[k * n:(k + 1) * n], frames,
                          edge_rssi=sys_rssi[:, k:k + 1], margin=0.36)
        st = s.state
        audio.append(s.audio)
        rssi.append(s.rssi)
        made = squelch.merge(made, s.gate)
    assert block.gate.edge == made.edge > 0
    assert block.gate.clear_db == pytest.approx(made.clear_db, abs=1e-9)
    assert block.gate[2:] == made[2:] and made.shut > 0
    # the gate acts: some channel-chunks shut
    assert (block.audio.reshape(M, 4, -1).abs().amax(-1) == 0).any()
    assert torch.allclose(block.audio, torch.cat(audio, 1), rtol=1e-9,
                          atol=1e-12)
    assert torch.allclose(block.rssi, torch.cat(rssi, 1), atol=1e-9)
    assert block.state.leaves.keys() == st.leaves.keys() == set(
        modes.load("AM").LEAVES + squelch.LEAVES)
    for k, a in block.state.leaves.items():
        assert torch.allclose(a, st.leaves[k], rtol=1e-9, atol=1e-12), k


@pytest.mark.parametrize("margin, flipped", [(0.36, True), (0.1, False)])
def test_edge_rssi_decides_only_within_the_margin(margin, flipped):
    """The reference's RSSI 0.2 dB under the open threshold: the system's
    (above it) opens the gate where the margin takes that in, and is not
    heard where it does not."""
    t = squelch.tables(SQ, 4)
    rssi = torch.tensor([[-62.2], [-30.0]], dtype=torch.float64)
    edge = torch.tensor([[-61.9], [-90.0]], dtype=torch.float64)
    _, leaves, made = squelch.apply(
        t, torch.ones(2, 8, dtype=torch.float64), rssi,
        _gate([0.0, 1.0], [0.0, 1.0]), edge_rssi=edge, margin=margin)
    assert leaves["squelch.open_"].tolist() == [float(flipped), 1.0]
    assert made.edge == made.opened == int(flipped)
    assert made.clear_db == pytest.approx(32.0 if flipped else 0.2)


# ---- the port's gate against the reference's

@pytest.mark.parametrize("tmajor", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_gate_matches_the_reference(seed, tmajor):
    C, n, L = 64, 700, 4
    g = torch.Generator().manual_seed(seed)
    rssi = -62.0 + 10.0 * torch.randn(C, generator=g)
    audio = torch.randn(C, n, generator=g)
    open_ = torch.randint(0, 2, (C,), generator=g).float()
    gain = torch.rand(C, generator=g)
    ref_t = squelch.tables(SQ, L)
    p = squelch_ops.make_squelch(enabled=True, thresh_db=SQ["thresh_db"],
                                 hyst_db=SQ["hyst_db"],
                                 ramp_samples=SQ["ramp_samples"])
    # at the audio rate, as the port's chain scales it
    p = p._replace(ramp=p.ramp / L)
    st = squelch_ops.SquelchState(open_=open_, gain=gain)
    if tmajor:
        got_st, got = squelch_ops.apply_squelch_tmajor(p, st, audio.T, rssi)
        got = got.T
    else:
        got_st, got = squelch_ops.apply_squelch(p, st, audio, rssi)
    want, leaves, _ = squelch.apply(
        ref_t, audio.double(), rssi.double()[:, None],
        {"squelch.open_": open_.double(), "squelch.gain": gain.double()})
    assert torch.allclose(got.double(), want, rtol=0, atol=1e-5)
    assert torch.equal(got_st.open_.double(), leaves["squelch.open_"])
    assert torch.allclose(got_st.gain.double(), leaves["squelch.gain"],
                          atol=1e-6)


# ---- whole runs at the small size

def _cell(seed=small.SEED, sq=SQ, cell=CELL, keyed=True):
    c = small.cell(cell, seed=seed,
                   conf_update={"deployment": {"squelch": sq}})
    if keyed:
        c.traffic["signal"]["keying"] = KEYING
    return c


def _opened_and_shut(lines):
    note = next(ln for ln in lines if ln.startswith("squelch: "))
    return tuple(int(v) for v in re.search(
        r"(\d+) gates opened and (\d+) shut", note).groups())


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("cell", ["hf2560_am_fast.replay",
                                  "hf2560_am_quality.replay"])
def test_squelched_run_is_correct_and_its_control_is_not(cell, keyed):
    result, lines = small.execute(_cell(cell=cell, keyed=keyed),
                                  system.program)
    assert result["correct"], result["compared"]
    opened, shut = _opened_and_shut(lines)
    # steady carriers only shut gates, in the first chunk; keyed ones
    # open them again
    assert shut > 0 and (opened > 0) is keyed
    result, _ = small.execute(_cell(cell=cell, keyed=keyed), system.Control)
    assert not result["correct"], result["compared"]


def _gate_never_applied(real):
    def gate(params, state, audioT, rssi_db):
        return real(params, state, audioT, rssi_db)[0], audioT
    return gate


def _state_reset_every_chunk(real):
    def gate(params, state, audioT, rssi_db):
        _, out = real(params, state, audioT, rssi_db)
        return squelch_ops.SquelchState(torch.ones_like(state.open_),
                                        torch.ones_like(state.gain)), out
    return gate


def _hard_switch(real):
    def gate(params, state, audioT, rssi_db):
        return real(params._replace(ramp=torch.ones_like(params.ramp)),
                    state, audioT, rssi_db)
    return gate


def _closes_at_thresh(real):
    def gate(params, state, audioT, rssi_db):
        return real(params._replace(hyst_db=torch.zeros_like(params.hyst_db)),
                    state, audioT, rssi_db)
    return gate


def _never_opens(real):
    """The `opens` term dropped: a shut gate sees an RSSI between the two
    thresholds wherever its own lies above them, and holds."""
    def gate(params, state, audioT, rssi_db):
        hold = params.thresh_db - 0.5 * params.hyst_db
        return real(params, state, audioT, torch.where(
            state.open_ < 0.5, torch.minimum(rssi_db, hold), rssi_db))
    return gate


def _opens_without_a_ramp(real):
    def gate(params, state, audioT, rssi_db):
        st, out = real(params, state, audioT, rssi_db)
        rising = st.open_ > state.gain
        return st, torch.where(rising, audioT.to(out.dtype), out)
    return gate


@pytest.mark.parametrize("fault", [_gate_never_applied,
                                   _state_reset_every_chunk, _hard_switch,
                                   _closes_at_thresh, _never_opens,
                                   _opens_without_a_ramp])
def test_broken_gate_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(squelch_ops, "apply_squelch_tmajor",
                        fault(squelch_ops.apply_squelch_tmajor))
    result, _ = small.execute(_cell(), system.program)
    assert not result["correct"], result["compared"]


def test_one_wrong_gate_in_one_chunk_fails_by_the_state_alone(monkeypatch):
    """A noise channel, far below the close threshold, opened in the
    window's second chunk alone: its audio may go unsampled, but its gate's
    state reads 1 against the reference's 0."""
    c = _cell()
    dep, tr = c.conf["deployment"], c.traffic
    cap = signal.make_capture(tr["signal"], dep["n_chan"], dep["fs_in"], 1,
                              8, c.seed, "cpu")
    b = int(np.setdiff1d(np.arange(dep["n_chan"]), cap.carrier_bins)[0])
    row = int(np.argsort(wb_prog.design.row_order(
        c.conf["rows"], dep["n_chan"]))[b])
    calls = [0]
    real = squelch_ops.apply_squelch_tmajor

    def gate(params, state, audioT, rssi_db):
        calls[0] += 1
        if calls[0] == tr["warmup_chunks"] + 2:
            rssi_db = rssi_db.clone()
            rssi_db[row] = 0.0
        return real(params, state, audioT, rssi_db)
    monkeypatch.setattr(squelch_ops, "apply_squelch_tmajor", gate)
    result, _ = small.execute(c, system.program)
    assert not result["correct"]
    assert result["compared"]["state_err"][0] == 1.0


def _carrier_rssi(seed):
    """A carrier's bin and the reference's RSSI there in chunk 0 (from the
    zero state), at the small size of the cell: one near −55 dB."""
    c = small.cell(CELL, seed=seed)
    dep, tr = c.conf["deployment"], c.traffic
    cap = signal.make_capture(tr["signal"], dep["n_chan"], dep["fs_in"],
                              tr["ring_chunks"], tr["frames"], seed, "cpu")
    t = pipeline.make_tables(dep, "cpu")
    r = pipeline.step(t, pipeline.zero_state(t, "cpu"), cap.re[0],
                      cap.im[0], tr["frames"]).rssi[:, 0]
    b = int(cap.carrier_bins[np.argmin(np.abs(
        r[cap.carrier_bins].numpy() + 55.0))])
    return b, float(r[b])


def _rssi_moved(real, row, delta, reported):
    """The gate decides on the program's RSSI moved by `delta` dB in one
    row; where `reported`, the program's RSSI output moves with it."""
    def gate(params, state, audioT, rssi_db):
        if not reported:
            rssi_db = rssi_db.clone()
        rssi_db[row] += delta
        return real(params, state, audioT, rssi_db)
    return gate


@pytest.mark.parametrize("below, delta, reported, ok", [
    # the reference's RSSI 0.1 dB under the close threshold, inside the
    # margin (0.36 dB): the program may hold the gate open or shut it
    (0.1, 0.2, True, True),
    (0.1, -0.2, True, True),
    # 0.6 dB under it, outside the margin: a program that holds it open
    # is wrong, though its RSSI is right
    (0.6, 0.8, False, False),
])
def test_edge_rule_either_decision_inside_the_margin_only(
        below, delta, reported, ok, monkeypatch):
    seed = small.SEED
    b, r_b = _carrier_rssi(seed)
    close = r_b + below
    sq = dict(SQ, thresh_db=close + SQ["hyst_db"])
    margin = check.load_limits(CELL)["rssi_err_db"]
    assert (below < margin) is ok
    c = _cell(seed, sq, keyed=False)
    dep = c.conf["deployment"]
    row = int(np.argsort(wb_prog.design.row_order(
        c.conf["rows"], dep["n_chan"]))[b])
    monkeypatch.setattr(squelch_ops, "apply_squelch_tmajor", _rssi_moved(
        squelch_ops.apply_squelch_tmajor, row, delta, reported))
    result, lines = small.execute(c, system.program)
    assert result["correct"] is ok, result["compared"]
    if ok:
        edges = next(ln for ln in lines if ln.startswith("squelch: "))
        assert not edges.startswith("squelch: 0 ")


# ---- configurations without a block read as before

@pytest.mark.parametrize("name", ["hf2560_am_fast", "hf2560_am_quality"])
def test_a_configuration_without_a_block_never_reaches_the_gate(
        name, monkeypatch):
    M, frames = 256, 128
    dep = _dep(name)
    re, im = _iq(M, frames, 2)
    t = pipeline.make_tables(dep, "cpu")
    assert t.sq is None
    z = pipeline.zero_state(t, "cpu")
    leaves = set(modes.load(dep["mode"]).LEAVES)
    assert set(z.leaves) == leaves
    plain = pipeline.step(t, z, re, im, frames)

    def never(*a, **k):
        raise AssertionError("the gate ran")
    monkeypatch.setattr(squelch, "apply", never)
    edged = pipeline.step(t, pipeline.zero_state(t, "cpu"), re, im, frames,
                          edge_rssi=plain.rssi + 0.1, margin=0.36)
    assert plain.gate == edged.gate == squelch.NONE
    assert torch.equal(plain.audio, edged.audio)
    assert torch.equal(plain.rssi, edged.rssi)
    for x, y in zip(plain.state[:3], edged.state[:3]):
        assert torch.equal(x, y)
    assert set(plain.state.leaves) == set(edged.state.leaves) == leaves
    for k, v in plain.state.leaves.items():
        assert torch.equal(v, edged.state.leaves[k]), k
    with open(R.BENCH / "configs" / f"{name}.json") as f:
        conf = json.load(f)
    conf["deployment"].update(n_chan=M, fs_in=M * 12000)
    prog = wb_prog.Program(conf, frames, "cpu")
    assert not prog.cfg.squelch_enabled
    assert set(prog.ref_state(prog.init_state()).leaves) == leaves


# ---- the program's configuration

@pytest.mark.parametrize("block, wideband, enabled", [
    (SQ, {}, True),
    (SQ, {"squelch_enabled": True}, True),
    (SQ, {"squelch_enabled": False}, None),
    (None, {}, False),
    (None, {"squelch_enabled": False}, False),
    (None, {"squelch_enabled": True}, None),
])
def test_the_block_sets_the_programs_gate(block, wideband, enabled):
    with open(R.BENCH / "configs" / "hf2560_am_fast.json") as f:
        conf = json.load(f)
    conf = copy.deepcopy(conf)
    conf["deployment"].update(n_chan=512, fs_in=512 * 12000)
    if block is not None:
        conf["deployment"]["squelch"] = block
    conf["wideband"] = wideband
    if enabled is None:
        with pytest.raises(ValueError, match="squelch"):
            wb_prog.config(conf, 64)
    else:
        assert wb_prog.config(conf, 64).squelch_enabled is enabled


def test_the_programs_state_carries_the_gate_in_bin_order():
    c = _cell()
    prog = system.program(c.conf, 64, "cpu")
    st = prog.init_state()
    M = c.conf["deployment"]["n_chan"]
    marked = torch.arange(M, dtype=torch.float32)
    chain = st.chain._replace(squelch=st.chain.squelch._replace(
        gain=marked))
    got = prog.ref_state(st._replace(chain=chain)).leaves
    assert torch.equal(got["squelch.gain"], marked.double())
    assert torch.equal(got["squelch.open_"], torch.ones(M,
                                                        dtype=torch.float64))
