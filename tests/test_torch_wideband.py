"""The port's wideband main path against the JAX package's, on the CPU.

Both packages run the planar tier at the JAX suite's planar test shape
(512 channels: factors (2, 256), T = 512, in-tail FIR (B, n_prev) =
(64, 2)) over two chained chunks, compared through each package's own
`audio_channel_order` (the port runs stage B unsplit, so its quality rows
are ordered differently from the reference's). The JAX side runs
`wideband.process` chunk by chunk (its `process_n` equals serial calls
sample for sample — tests/test_wideband.py) in Pallas interpret mode;
the port runs its plain versions.

Tolerances: audio SNR ≥ 85 dB on quality (both ~f32; the reference's
split-bf16 ×3 dots set the floor, measured ~100 dB here) and ≥ 45 dB on
fast (the bf16 comparison class of tests/test_wideband.py); RSSI within
0.05 dB. Against the JAX plain-path oracle (default tuning, XLA f32):
≥ 45 dB fast and ≥ 90 dB quality — the reference itself scores 52.8 /
49.3 and 104.2 / 102.1 dB at this shape and seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.runtime import wideband as jwb
from supersdr_tpu_torch import convert
from supersdr_tpu_torch.ops import cx as tcx
from supersdr_tpu_torch.runtime import wideband as twb

BASE = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
            taps_per=4, n_taps=129)
SNR_MIN = {"fast": 45.0, "quality": 85.0}
ORACLE_MIN = {"fast": 45.0, "quality": 90.0}
NBFM_SKIP = 1280          # audio samples of FIR + attack transient


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _inputs(mode):
    """Two chunks: noise for AM/USB (seed 11, as the reference's planar
    tests); for NBFM, FM carriers at 16 channel centres over a −52 dB
    floor with Carson-safe deviation (bench.py's NBFM gate recipe)."""
    n = BASE["chunk_in"]
    if mode != "NBFM":
        rng = np.random.default_rng(11)
        return ((rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n)))
                * 0.05).astype(np.complex64), None
    rng = np.random.default_rng(6)
    C, fs = BASE["n_chan"], BASE["fs_in"]
    t = np.arange(2 * n) / fs
    z = 0.01 * (rng.normal(size=2 * n) + 1j * rng.normal(size=2 * n))
    kbins = rng.choice(C, size=16, replace=False)
    for k in kbins:
        fk = (k if k < C // 2 else k - C) * (fs / C)
        g = rng.uniform(300.0, 1000.0)
        beta = rng.uniform(1.0, 2.5)
        z = z + 0.4 * np.exp(1j * (2 * np.pi * fk * t
                                   + beta * np.sin(2 * np.pi * g * t)))
    return z.astype(np.complex64).reshape(2, n), kbins


def _kw(mode):
    return dict(agc_kwargs=dict(on=False)) if mode == "NBFM" else {}


def _to_bin(audioT, order):
    """[T·L, C] planar rows → [C, T·L] in PFB bin order."""
    return np.asarray(audioT).T[np.argsort(order)]


@pytest.fixture(scope="module")
def jax_runs():
    """The reference's outputs per (mode, tier), computed on first use."""
    cache = {}

    def get(mode, tier):
        if (mode, tier) not in cache:
            cfg = jwb.WidebandConfig(**BASE, mode=mode,
                                     **jwb.PROFILES[tier])
            p = jwb.make_params(cfg, **_kw(mode))
            iq, kbins = _inputs(mode)
            st = jwb.init_state(cfg)
            states, audio, rssi = [], [], []
            for k in range(2):
                st, out = jwb.process(cfg, p, st, iq[k])
                states.append(st)
                audio.append(_to_bin(out.audio, jwb.audio_channel_order(cfg)))
                rssi.append(np.asarray(out.rssi)[
                    np.argsort(jwb.audio_channel_order(cfg))])
            cache[mode, tier] = dict(cfg=cfg, params=p, iq=iq, kbins=kbins,
                                     states=states, audio=audio, rssi=rssi)
        return cache[mode, tier]
    return get


def _port(mode, tier, iq, state=None):
    cfg = twb.WidebandConfig(**BASE, mode=mode, **twb.PROFILES[tier])
    p = twb.make_params(cfg, **_kw(mode), device="cpu")
    st = twb.init_state(cfg, device="cpu") if state is None else state
    order = twb.audio_channel_order(cfg)
    st_n, outs = twb.process_n(cfg, p, st, list(iq))
    rssi = []
    for q in iq:                       # RSSI rows from process
        st, out = twb.process(cfg, p, st, q)
        rssi.append(out.rssi.numpy()[np.argsort(order)])
    return cfg, p, st_n, [_to_bin(a, order) for a in outs], rssi


@pytest.mark.parametrize("mode,tier", [("AM", "fast"), ("AM", "quality"),
                                       ("USB", "quality"),
                                       ("NBFM", "quality")])
def test_process_n_matches_reference(jax_runs, mode, tier):
    ref = jax_runs(mode, tier)
    _, _, _, audio, rssi = _port(mode, tier, ref["iq"])
    for k in range(2):
        assert audio[k].shape == ref["audio"][k].shape == (512, 2048)
        r, g = ref["audio"][k], audio[k]
        if mode == "NBFM":
            r = r[ref["kbins"], NBFM_SKIP if k == 0 else 0:]
            g = g[ref["kbins"], NBFM_SKIP if k == 0 else 0:]
        snr = _snr(r, g)
        assert snr >= SNR_MIN[tier], (mode, tier, k, snr)
        np.testing.assert_allclose(rssi[k], ref["rssi"][k], atol=0.05)


@pytest.mark.parametrize("tier", ["fast", "quality"])
def test_process_n_against_plain_path_oracle(tier):
    cfg = jwb.WidebandConfig(**BASE, mode="AM")          # default tuning
    assert not jwb._planar_active(cfg)
    iq, _ = _inputs("AM")
    _, oracle = jwb.process_many(cfg, jwb.make_params(cfg),
                                 jwb.init_state(cfg), iq)
    oracle = np.asarray(oracle)                          # [2, C, T·L] bins
    _, _, _, audio, _ = _port("AM", tier, iq)
    for k in range(2):
        snr = _snr(oracle[k], audio[k])
        assert snr >= ORACLE_MIN[tier], (tier, k, snr)


@pytest.mark.parametrize("tier", ["fast", "quality"])
def test_process_i16_equals_dequantized_f32(tier):
    cfg = twb.WidebandConfig(**BASE, mode="AM", **twb.PROFILES[tier])
    p = twb.make_params(cfg, device="cpu")
    rng = np.random.default_rng(41)
    st_a = st_b = twb.init_state(cfg, device="cpu")
    for _ in range(2):
        re16 = (rng.normal(size=cfg.chunk_in) * 1600).astype(np.int16)
        im16 = (rng.normal(size=cfg.chunk_in) * 1600).astype(np.int16)
        deq = tcx.CX(torch.from_numpy(re16).float() / 32768.0,
                     torch.from_numpy(im16).float() / 32768.0)
        st_a, out_a = twb.process_i16(cfg, p, st_a, (re16, im16))
        st_b, out_b = twb.process(cfg, p, st_b, deq)
        np.testing.assert_allclose(out_a.audio.numpy(), out_b.audio.numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_state_carries_across_packages(jax_runs):
    """A JAX state after chunk 0 resumes in the port for chunk 1, and a
    port state after chunk 0 resumes in the JAX package."""
    ref = jax_runs("AM", "quality")
    cfg = twb.WidebandConfig(**BASE, mode="AM", **twb.PROFILES["quality"])
    p = twb.make_params(cfg, device="cpu")
    order = twb.audio_channel_order(cfg)
    # JAX → port
    st = convert.state_from_jax(ref["states"][0], device="cpu")
    _, out = twb.process(cfg, p, st, ref["iq"][1])
    assert _snr(ref["audio"][1], _to_bin(out.audio, order)) \
        >= SNR_MIN["quality"]
    np.testing.assert_allclose(out.rssi.numpy()[np.argsort(order)],
                               ref["rssi"][1], atol=0.05)
    # port → JAX
    st0, out0 = twb.process(cfg, p, twb.init_state(cfg, device="cpu"),
                            ref["iq"][0])
    _, out1 = twb.process(cfg, p, st0, ref["iq"][1])
    leaves = jax.tree_util.tree_leaves(convert.to_numpy(st0))
    jst = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(ref["states"][0]),
        [jnp.asarray(v) for v in leaves])
    _, jout = jwb.process(ref["cfg"], ref["params"], jst, ref["iq"][1])
    assert _snr(_to_bin(jout.audio, jwb.audio_channel_order(ref["cfg"])),
                _to_bin(out1.audio, order)) >= SNR_MIN["quality"]


def test_state_layout_matches_reference():
    jcfg = jwb.WidebandConfig(**BASE, **jwb.PROFILES["fast"])
    tcfg = twb.WidebandConfig(**BASE, **twb.PROFILES["fast"])
    js = jwb.init_state(jcfg)
    ts = convert.to_numpy(twb.init_state(tcfg, device="cpu"))
    jl, jt = jax.tree_util.tree_flatten(js)
    tl = jax.tree_util.tree_leaves(ts)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert [type(x).__name__ for x in ts] == [type(x).__name__ for x in js]


@pytest.mark.parametrize("mode", ["AM", "USB", "NBFM"])
def test_make_params_matches_params_from_jax(mode):
    jcfg = jwb.WidebandConfig(**BASE, mode=mode, **jwb.PROFILES["quality"])
    tcfg = twb.WidebandConfig(**BASE, mode=mode, **twb.PROFILES["quality"])
    conv = convert.params_from_jax(jwb.make_params(jcfg), device="cpu")
    own = twb.make_params(tcfg, device="cpu")
    for a, b in ((own.W_pfb, conv.W_pfb),
                 (own.chain.W_tailpass, conv.chain.W_tailpass),
                 (own.chain.P_interp, conv.chain.P_interp)):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
    for a, b in zip(own.chain.agc + own.chain.squelch,
                    conv.chain.agc + conv.chain.squelch):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("extra", [
    dict(chunk_in=512 * 520, **twb.PROFILES["fast"]),
    dict(n_taps=33, **twb.PROFILES["fast"]),
    dict(chan_impl="mxu2pallas")])
def test_outside_the_slice_raises(extra):
    """What the port does not run raises, naming the ROADMAP item: the
    reference's superseded channelizer variants. The time-major fused tier
    off the planar coupling (a chunk that chan_tile_t does not divide; a
    passband too short for the in-tail FIR block) raised here until it was
    ported: now it runs, in bin order (tests/test_torch_wideband_tmajor.py
    holds it against the reference)."""
    cfg = twb.WidebandConfig(**{**BASE, **extra})
    assert not twb._planar_active(cfg)
    args = (cfg, twb.make_params(cfg, device="cpu"),
            twb.init_state(cfg, device="cpu"),
            np.zeros(cfg.chunk_in, np.complex64))
    if extra.get("chan_impl") == "mxu2pallas":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            twb.process(*args)
        return
    assert twb._tmajor_fused_ok(cfg)
    _, out = twb.process(*args)
    assert out.audio.shape == (cfg.chunk_per_chan * 4, cfg.n_chan)
    assert bool(torch.isfinite(out.audio).all())
    assert (out.baseband is None) == (extra.get("n_taps") != 33)
    np.testing.assert_array_equal(twb.audio_channel_order(cfg),
                                  np.arange(cfg.n_chan))


@pytest.mark.parametrize("kw", [
    dict(BASE, **jwb.PROFILES["fast"]),
    dict(BASE, **jwb.PROFILES["quality"]),
    dict(BASE, mode="NBFM", **jwb.PROFILES["quality"]),
    dict(BASE),
    dict(BASE, **dict(jwb.PROFILES["fast"], time_major=False)),
    dict(fs_in=16 * 12_000, n_chan=16, chunk_in=16 * 512, taps_per=4,
         n_taps=129, **jwb.PROFILES["fast"]),
    dict(fs_in=2560 * 12_000, n_chan=2560, chunk_in=2560 * 512,
         **jwb.PROFILES["quality"]),
    dict(fs_in=2560 * 12_000, n_chan=2560, chunk_in=2560 * 16128,
         **jwb.PROFILES["fast"]),
    dict(BASE, n_taps=33, **jwb.PROFILES["fast"]),
    dict(BASE, chunk_in=512 * 96, **jwb.PROFILES["quality"])])
def test_planar_predicate_matches_reference(kw):
    tcfg, jcfg = twb.WidebandConfig(**kw), jwb.WidebandConfig(**kw)
    assert twb._planar_active(tcfg) == jwb._planar_active(jcfg)
    assert twb._tmajor_fused_ok(tcfg) == jwb._tmajor_fused_ok(jcfg)


@pytest.mark.parametrize("tier,n1", [("fast", 10), ("quality", 10)])
def test_order_maps_at_headline(tier, n1):
    cfg = twb.WidebandConfig(fs_in=30_720_000, n_chan=2560,
                             chunk_in=2560 * 16128, **twb.PROFILES[tier])
    assert twb._planar_active(cfg)
    assert twb._factors_for(cfg) == (n1, 256)
    order = twb.audio_channel_order(cfg)
    assert sorted(order) == list(range(2560))
    assert order[0] == 0 and order[1] == n1
    freqs = twb.channel_freqs(cfg)
    assert freqs[1] == pytest.approx(n1 * 12_000.0)


def test_carriers_land_on_their_rows():
    """AM carriers at channel_freqs(cfg)[r] demodulate into audio row r:
    the two loudest RSSI rows are the carriers' rows."""
    cfg = twb.WidebandConfig(**BASE, mode="AM", **twb.PROFILES["fast"])
    p = twb.make_params(cfg, device="cpu")
    freqs = twb.channel_freqs(cfg)
    rng = np.random.default_rng(31)
    rows = [7, 300]
    t = np.arange(cfg.chunk_in) / cfg.fs_in
    z = 0.02 * (rng.normal(size=cfg.chunk_in)
                + 1j * rng.normal(size=cfg.chunk_in))
    for r in rows:
        z = z + 0.5 * (1 + 0.5 * np.sin(2 * np.pi * 700 * t)) \
            * np.exp(2j * np.pi * freqs[r] * t)
    st = twb.init_state(cfg, device="cpu")
    for _ in range(2):
        st, out = twb.process(cfg, p, st, z.astype(np.complex64))
    top = set(np.argsort(out.rssi.numpy()[:, 0])[::-1][:2])
    assert top == set(rows)


def test_float_pair_is_rejected():
    cfg = twb.WidebandConfig(**BASE, **twb.PROFILES["fast"])
    p = twb.make_params(cfg, device="cpu")
    re = np.zeros(cfg.chunk_in, np.float32)
    with pytest.raises(TypeError, match="int16"):
        twb.process(cfg, p, twb.init_state(cfg, device="cpu"), (re, re))
