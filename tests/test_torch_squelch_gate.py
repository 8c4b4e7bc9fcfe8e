"""The time-major squelch gate's wrapper (`ops/cuda/squelch_gate.py`) on the
CPU, where it runs its plain version.

Each case is held bit for bit (`torch.equal`, which takes −0.0 equal to
+0.0) against the sequence the chain ran before the wrapper: the state
gathered by `order`, `ops/squelch.apply_squelch_tmajor`, the state
scattered back by the inverse permutation. A model of the kernel's tiles
in float32 (`_kernel_model`: a tile of 64 rows whose first gain equals a
channel's target leaves a settled-open channel alone and stores zeros for
a settled-shut one; every other vector is scaled row by row) is held to
the same result, which checks the kernel's design claim that a settled
tile stays settled: `csrc/squelch_gate.cu` itself runs only on a card
(`chip_smoke.py`'s squelch phase holds it to the plain version there)."""

import pytest
import torch

from supersdr_tpu_torch.ops import squelch as squelch_ops
from supersdr_tpu_torch.ops.cuda import squelch_gate

THRESH, HYST = -70.0, 6.0
N_ROWS = 4000                 # 62 tiles of 64 rows and a short one
TILE = 64                     # the kernel's kTileRows
UPSAMPLE = 4
DTYPES = (torch.float32, torch.float16, torch.bfloat16)

# rssi levels: opens (≥ thresh), holds (between the two thresholds), closes
RSSI = {"open": -60.0, "hold": -73.0, "shut": -90.0}


def _classes(name: str, gen: torch.Generator, C: int):
    """(open, gain, rssi, enabled, ramp_samples) of one case."""
    def full(v):
        return torch.full((C,), v, dtype=torch.float32)

    def rand(*shape):
        return torch.rand(*shape, generator=gen)
    ramp = 240
    enabled = True
    if name == "settled_open":
        open_, gain, rssi = full(1.0), full(1.0), full(RSSI["open"])
    elif name == "settled_shut":
        open_, gain, rssi = full(0.0), full(0.0), full(RSSI["shut"])
    elif name == "opening":
        open_, gain, rssi = full(0.0), full(0.0), full(RSSI["open"])
    elif name == "closing":
        open_, gain, rssi = full(1.0), full(1.0), full(RSSI["shut"])
    elif name == "mid_ramp":
        open_ = (rand(C) < 0.5).float()
        gain, rssi = rand(C), full(RSSI["hold"])
    elif name == "ramp_ends_inside":
        # 1000 audio samples: the ramp ends inside the block and inside a
        # tile (1000 is no multiple of 64), from either end
        open_ = (rand(C) < 0.5).float()
        gain, rssi, ramp = open_.clone(), torch.where(
            open_ > 0, full(RSSI["shut"]), full(RSSI["open"])), 250
    elif name == "slow_ramp":
        # longer than the block: no tile after the first settles
        open_, gain, rssi, ramp = full(0.0), full(0.0), full(RSSI["open"]), \
            5000
    elif name == "disabled":
        open_ = (rand(C) < 0.5).float()
        gain, enabled = rand(C).round(), False
        rssi = torch.tensor(list(RSSI.values()))[
            torch.randint(0, 3, (C,), generator=gen)]
    elif name.startswith("mixed"):
        # every class side by side, so one 16-byte vector mixes them
        open_ = (rand(C) < 0.5).float()
        gain = torch.where(rand(C) < 0.3, rand(C), (rand(C) < 0.5).float())
        rssi = torch.tensor(list(RSSI.values()))[
            torch.randint(0, 3, (C,), generator=gen)]
    else:
        raise KeyError(name)
    return open_, gain, rssi, enabled, ramp


CASES = {"settled_open": 64, "settled_shut": 64, "opening": 64,
         "closing": 64, "mid_ramp": 64, "ramp_ends_inside": 64,
         "slow_ramp": 64, "disabled": 64, "mixed": 64,
         # 37 channels: no 16-byte rows, the kernel's one-lane form
         "mixed_odd_channels": 37}


def _inputs(name: str, dtype: torch.dtype, with_order: bool, seed: int = 3):
    C = CASES[name]
    gen = torch.Generator().manual_seed(seed)
    open_, gain, rssi, enabled, ramp = _classes(name, gen, C)
    sq = squelch_ops.make_squelch(enabled=enabled, thresh_db=THRESH,
                                  hyst_db=HYST, ramp_samples=ramp,
                                  device="cpu")
    params = squelch_ops.SquelchParams(sq.enabled, sq.thresh_db, sq.hyst_db,
                                       sq.ramp / float(UPSAMPLE))
    order = torch.randperm(C, generator=gen) if with_order else None
    # the state in bin order: row c holds bin order[c]'s class
    state = squelch_ops.SquelchState(open_, gain)
    if order is not None:
        state = squelch_ops.SquelchState(
            *(torch.empty_like(v).index_put_((order,), v) for v in state))
    audioT = (torch.randn(N_ROWS, C, generator=gen) * 0.3).to(dtype)
    return params, state, audioT, rssi, order


def _before(params, state, audioT, rssi, order):
    """The chain's gate before the wrapper."""
    if order is None:
        return squelch_ops.apply_squelch_tmajor(params, state, audioT, rssi)
    inv = torch.argsort(order)
    sq_in = squelch_ops.SquelchState(*(v[order] for v in state))
    gated, out = squelch_ops.apply_squelch_tmajor(params, sq_in, audioT,
                                                  rssi)
    return squelch_ops.SquelchState(*(v[inv] for v in gated)), out


def _kernel_model(params, state, audioT, rssi, order):
    """`csrc/squelch_gate.cu`'s tiles and vector classes in float32."""
    n, C = audioT.shape
    esz = audioT.element_size()
    lanes = 16 // esz if C % (16 // esz) == 0 else 1
    b = torch.arange(C) if order is None else order
    g0 = state.gain[b]
    target = squelch_ops._open_now(
        params, squelch_ops.SquelchState(state.open_[b], g0), rssi)
    sgn = torch.sign(target - g0)
    sr = sgn * params.ramp
    lo, hi = torch.minimum(g0, target), torch.maximum(g0, target)
    x = audioT.float()
    out = audioT.clone()
    for r0 in range(0, n, TILE):
        t = torch.arange(r0 + 1, min(r0 + TILE, n) + 1, dtype=torch.float32)
        first = torch.clamp(g0 + sr * t[0], lo, hi)
        settled = first == target

        def whole(m):
            return m.view(-1, lanes).all(1).repeat_interleave(lanes)
        skip = whole(settled & (target == 1))
        zero = whole(settled & (target == 0))
        gain = torch.clamp(g0 + sr * t[:, None], lo, hi)
        rows = slice(r0, r0 + len(t))
        scaled = (x[rows] * gain).to(audioT.dtype)
        out[rows] = torch.where(skip, out[rows],
                                torch.where(zero, torch.zeros_like(scaled),
                                            scaled))
    g_last = torch.clamp(g0 + sgn * (params.ramp * n), lo, hi)
    new = [torch.empty_like(v) for v in state]
    new[0][b], new[1][b] = target, g_last
    return squelch_ops.SquelchState(*new), out


@pytest.mark.parametrize("with_order", [False, True],
                         ids=["order_none", "order"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("case", list(CASES))
def test_gate_equals_the_chains_earlier_gate(case, dtype, with_order):
    params, state, audioT, rssi, order = _inputs(case, dtype, with_order)
    launches = squelch_gate.squelch_gate_tmajor.launches
    want_state, want = _before(params, state, audioT.clone(), rssi, order)
    got_state, got = squelch_gate.squelch_gate_tmajor(
        params, state, audioT.clone(), rssi, order)
    model_state, model = _kernel_model(params, state, audioT, rssi, order)
    assert squelch_gate.squelch_gate_tmajor.launches == launches
    assert got.dtype == want.dtype == model.dtype == dtype
    assert torch.equal(got, want) and torch.equal(model, want)
    for w, g, m in zip(want_state, got_state, model_state):
        assert torch.equal(g, w) and torch.equal(m, w)
    # the case does what it names
    moved = (want.float() != audioT.float()).any(0)
    if case == "settled_open":
        assert not moved.any()
    if case in ("settled_shut", "closing", "ramp_ends_inside"):
        assert moved.all()
    if case in ("opening", "closing", "ramp_ends_inside"):
        assert torch.equal(want_state.gain, want_state.open_)
    if case == "slow_ramp":
        assert bool(((want_state.gain > 0) & (want_state.gain < 1)).all())


def _good(C: int = 16, n: int = 128):
    params, state, audioT, rssi, _ = _inputs("mixed", torch.float32, False)
    return params, state, audioT[:n, :C].contiguous(), rssi[:C], None


def _state_c(st, C):
    return squelch_ops.SquelchState(st.open_[:C], st.gain[:C])


@pytest.mark.parametrize("what", [
    "non_contiguous_audio", "audio_1d", "audio_float64", "empty_audio",
    "rssi_length", "state_length", "order_length", "order_int32",
    "rssi_on_other_device", "param_not_scalar"])
def test_gate_refuses_what_the_kernel_does_not_take(what):
    params, state, audioT, rssi, order = _good()
    C = audioT.shape[1]
    state = _state_c(state, C)
    if what == "non_contiguous_audio":
        audioT = audioT.T.contiguous().T
    elif what == "audio_1d":
        audioT = audioT[0]
    elif what == "audio_float64":
        audioT = audioT.double()
    elif what == "empty_audio":
        audioT = audioT[:0]
    elif what == "rssi_length":
        rssi = torch.cat([rssi, rssi[:1]])
    elif what == "state_length":
        state = squelch_ops.SquelchState(state.open_[:-1], state.gain)
    elif what == "order_length":
        order = torch.arange(C + 1)
    elif what == "order_int32":
        order = torch.arange(C, dtype=torch.int32)
    elif what == "rssi_on_other_device":
        rssi = rssi.to("meta")
    elif what == "param_not_scalar":
        params = params._replace(thresh_db=params.thresh_db.repeat(C))
    launches = squelch_gate.squelch_gate_tmajor.launches
    with pytest.raises(ValueError):
        squelch_gate.squelch_gate_tmajor(params, state, audioT, rssi, order)
    assert squelch_gate.squelch_gate_tmajor.launches == launches
