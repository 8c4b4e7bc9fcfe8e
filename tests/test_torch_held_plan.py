"""A stream's fixed plan, held across chunks (`utils/held.py`), on the CPU.

Chunks run with their plan held give bit for bit what chunks run cold give
(every cache emptied and the configuration copied anew before each chunk)
on the planar, time-major and chan-major tiers and on the sharded wideband
over 2 shards; the held inverse row order is the order's argsort; a
parameter tensor rewritten in place, or a new parameters object, is read
anew by the next chunk; and the plan counter records one build and then
a hit a chunk, only while a profiler runs.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from supersdr_tpu_torch.parallel import sharded_wideband as sw
from supersdr_tpu_torch.runtime import wideband as wb
from supersdr_tpu_torch.utils import held, profiling

PLANAR = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
              taps_per=4, n_taps=129, mode="AM", **wb.PROFILES["fast"])
# the quality tier, with the AGC hang and the squelch (its ramp is held)
GATED = dict(PLANAR, **wb.PROFILES["quality"], hang_enabled=True,
             squelch_enabled=True)
TMAJOR = dict(PLANAR, chunk_in=512 * 264)        # frames % chan_tile_t ≠ 0
# ≥ 128 channels: the chain-major tail (its parameter vector is held)
CHANMAJOR = dict(fs_in=128 * 12_000, n_chan=128, chunk_in=128 * 512,
                 taps_per=8, n_taps=129, mode="AM", passband_impl="matmul",
                 tail_impl="pallas")
N_CHUNKS = 3


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _iqs(cfg, n=N_CHUNKS, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(-3000, 3000, cfg.chunk_in).astype(np.int16)
                  for _ in range(2)) for _ in range(n)]


def _leaves(state):
    return torch.utils._pytree.tree_leaves(state)


def _assert_same(a, b):
    (sa, aa, ra), (sb, ab, rb) = a, b
    assert torch.equal(aa, ab) and torch.equal(ra, rb)
    la, lb = _leaves(sa), _leaves(sb)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _serial(cfg, params, state, iq):
    st, out = wb.process_i16(cfg, params, state, iq)
    return st, out.audio, out.rssi


def _run(kw, cold: bool, shards: int = 0):
    """N_CHUNKS chunks from zero state: [(state, audio, rssi)]; `cold`
    empties every cache and copies the configuration before each chunk
    (the mesh is then built anew for it too)."""
    cfg = wb.WidebandConfig(**kw)
    params = wb.make_params(cfg, device="cpu")
    state = wb.init_state(cfg, device="cpu")

    def step_fn(c):
        if not shards:
            return lambda p, s, iq: _serial(c, p, s, iq)
        return sw.build(c, sw.make_mesh(shards, device="cpu"))
    step = step_fn(cfg)
    out = []
    for iq in _iqs(cfg):
        if cold:
            held.clear()
            step = step_fn(dataclasses.replace(cfg))
        state, audio, rssi = step(params, state, iq)
        out.append((state, audio, rssi))
    return out


@pytest.mark.parametrize("kw, shards", [(PLANAR, 0), (GATED, 0), (TMAJOR, 0),
                                        (CHANMAJOR, 0), (PLANAR, 2)],
                         ids=["planar", "planar-gated", "tmajor",
                              "chanmajor", "mesh2"])
def test_held_plan_gives_the_cold_plans_outputs_bit_for_bit(kw, shards):
    held_runs = _run(kw, cold=False, shards=shards)
    cold_runs = _run(kw, cold=True, shards=shards)
    for a, b in zip(held_runs, cold_runs):
        _assert_same(a, b)


def test_the_tiers_are_the_ones_named():
    dev = torch.device("cpu")
    tiers = {name: wb._plan(wb.WidebandConfig(**kw), dev).tier.__name__
             for name, kw in (("planar", PLANAR), ("gated", GATED),
                              ("tmajor", TMAJOR), ("chan", CHANMAJOR))}
    assert tiers == {"planar": "_process_planar", "gated": "_process_planar",
                     "tmajor": "_process_tmajor_fused",
                     "chan": "_process_chan_major"}
    proc = sw.build(wb.WidebandConfig(**PLANAR), sw.make_mesh(2, device="cpu"))
    assert proc.tier == "planar"


@pytest.mark.parametrize("kw", [PLANAR, GATED], ids=["fast", "quality"])
def test_the_held_inverse_is_the_argsort_of_the_order(kw):
    cfg = wb.WidebandConfig(**kw)
    plan = wb._plan(cfg, torch.device("cpu"))
    assert torch.equal(plan.order,
                       torch.as_tensor(wb.audio_channel_order(cfg)))
    assert torch.equal(plan.inv, torch.argsort(plan.order))
    assert not torch.equal(plan.inv, torch.arange(cfg.n_chan))
    # the plan, and a configuration's chain configuration, are made once
    assert wb._plan(cfg, torch.device("cpu")) is plan
    assert cfg.chain_cfg is cfg.chain_cfg and plan.ccfg == cfg.chain_cfg


def _rewrite_pfb(params, cfg):
    params.W_pfb.copy_(params.W_pfb * 0.5)
    return params


def _rewrite_agc(params, cfg):
    params.chain.agc.target_db.copy_(torch.tensor(-25.0))
    return params


def _new_params(params, cfg):
    return wb.make_params(cfg, device="cpu",
                          agc_kwargs=dict(target_db=-30.0, thresh_db=-60.0))


@pytest.mark.parametrize("kw", [PLANAR, CHANMAJOR],
                         ids=["planar", "chanmajor"])
@pytest.mark.parametrize("change", [_rewrite_pfb, _rewrite_agc, _new_params],
                         ids=["pfb-copy_", "agc-copy_", "new-params"])
def test_changed_params_are_read_by_the_next_chunk(kw, change):
    """After a chunk on held params, the params change; the next chunk
    equals a cold chunk on the changed params, and differs from a chunk on
    the unchanged ones (so the change shows)."""
    cfg = wb.WidebandConfig(**kw)
    params = wb.make_params(cfg, device="cpu")
    iq0, iq1 = _iqs(cfg, 2, seed=5)
    state, _, _ = _serial(cfg, params, wb.init_state(cfg, device="cpu"), iq0)
    unchanged = _serial(cfg, params, state, iq1)
    params = change(params, cfg)
    got = _serial(cfg, params, state, iq1)
    held.clear()
    cold = _serial(dataclasses.replace(cfg), params, state, iq1)
    _assert_same(got, cold)
    assert not torch.equal(got[1], unchanged[1])


def _plan_records(cfg, params, n):
    state = wb.init_state(cfg, device="cpu")
    chunks = []
    with profile(activities=[ProfilerActivity.CPU]):
        for iq in _iqs(cfg, n):
            state, _, _ = _serial(cfg, params, state, iq)
            chunks.append(profiling.spans()[-1].chunk)
    rec = profiling.plans()
    return [rec.get(c) for c in chunks]


def test_the_counter_records_one_build_then_a_hit_a_chunk():
    held.clear()
    cfg = wb.WidebandConfig(**PLANAR)
    params = wb.make_params(cfg, device="cpu")
    assert _plan_records(cfg, params, 4) == [True, False, False, False]
    # a second configuration builds its own plan; the first stays held
    other = wb.WidebandConfig(**TMAJOR)
    assert _plan_records(other, wb.make_params(other, device="cpu"), 2) == \
        [True, False]
    assert _plan_records(cfg, params, 2) == [False, False]
    # a new params object is built anew; without a profiler nothing counts
    assert _plan_records(cfg, wb.make_params(cfg, device="cpu"), 2) == \
        [True, False]
    profiling.clear_spans()
    _serial(cfg, params, wb.init_state(cfg, device="cpu"), _iqs(cfg, 1)[0])
    assert not profiling.recording() and profiling.plans() == {}


def test_from_tensors_holds_by_identity_and_version():
    calls = []

    def build(a, b, k):
        calls.append(k)
        return a * k + b
    memo = held.FromTensors(build, maxsize=2)
    a, b = torch.ones(3), torch.zeros(3)
    first = memo((a, b), 2.0)
    assert memo((a, b), 2.0) is first and calls == [2.0]
    b.add_(1.0)                                     # in place: a new version
    assert torch.equal(memo((a, b), 2.0), torch.full((3,), 3.0))
    assert len(calls) == 2
    assert memo((a.clone(), b), 2.0) is not first   # another tensor
    assert memo((a, b), 5.0)[0] == 6.0              # another static key
    assert len(memo.cache) == 2                     # the oldest dropped
    with torch.inference_mode():                    # no version: not held
        c = torch.ones(3)
    memo((c, b), 1.0)
    memo((c, b), 1.0)
    assert calls[-2:] == [1.0, 1.0]
    held.clear()
    assert memo.cache == {}
