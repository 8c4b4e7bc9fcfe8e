"""The port's wideband chan-major and fallback tiers, and the planar tier's
hang and squelch, against the JAX package's on the CPU.

Both packages run `wideband.process` over two chained chunks on the same
seeded numpy IQ; outputs are compared through each package's own
`audio_channel_order` (identity off the planar tier). The reference's
Pallas kernels (`pfb_fold`, `chain_tail_am`, the fused channelizer) run
in interpret mode; the port's wrappers run their plain versions.

Tolerances: audio SNR ≥ 80 dB on the float32 tiers — the DC pole and the
AGC's exp amplify float32 summation-order differences (FFT against DFT
products, scans in another order) to ~1e-5 relative; ≥ 85 dB on the
planar quality tier (tests/test_torch_wideband.py's bound); RSSI within
0.01 dB (0.05 dB planar: the in-kernel power row).
"""

import jax
import numpy as np
import pytest
import torch

from supersdr_tpu.runtime import wideband as jwb
from supersdr_tpu_torch import convert
from supersdr_tpu_torch.runtime import wideband as twb

AUDIO_DB = 80.0
PLANAR_DB = 85.0


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _iq(n_chunks, n, seed=11):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n_chunks, n)) + 1j * rng.normal(
        size=(n_chunks, n))) * 0.05).astype(np.complex64)


def _bursty_iq(cfg, seed=5):
    """Three chunks of noise whose level steps up and down within the
    first (so the hang holds and releases) and is 20 dB down in the other
    two (so the squelch closes once the loud chunk's history has left the
    filters). Every channel sees the same level: a loud channel
    beside a quiet one would leak the reference's split-bf16 channelizer
    rounding (relative to the loud one) into the quiet one's comparison."""
    rng = np.random.default_rng(seed)
    n = cfg.chunk_in
    z = (rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))) * 0.05
    t = np.arange(n) / cfg.fs_in
    z[0] *= 0.2 + 0.8 * (np.sin(2 * np.pi * 60.0 * t) > 0)
    z[1:] *= 0.1
    return z.astype(np.complex64)


def _rows(audio, order, time_major):
    a = np.asarray(audio)
    return (a.T if time_major else a)[np.argsort(order)]


def _compare(kw, iq, pkw=None, bound=AUDIO_DB, rssi_atol=0.01):
    pkw = pkw or {}
    jcfg, tcfg = jwb.WidebandConfig(**kw), twb.WidebandConfig(**kw)
    assert twb._planar_active(tcfg) == jwb._planar_active(jcfg)
    assert twb._tmajor_fused_ok(tcfg) == jwb._tmajor_fused_ok(jcfg)
    jp = jwb.make_params(jcfg, **pkw)
    tp = twb.make_params(tcfg, **pkw, device="cpu")
    js, ts = jwb.init_state(jcfg), twb.init_state(tcfg, device="cpu")
    jo_ord = jwb.audio_channel_order(jcfg)
    to_ord = twb.audio_channel_order(tcfg)
    for k in range(iq.shape[0]):
        js, jo = jwb.process(jcfg, jp, js, iq[k])
        ts, to = twb.process(tcfg, tp, ts, iq[k])
        ref = _rows(jo.audio, jo_ord, jcfg.time_major)
        got = _rows(to.audio.float(), to_ord, tcfg.time_major)
        assert got.shape == ref.shape
        snr = _snr(ref, got)
        assert snr >= bound, (k, snr)
        np.testing.assert_allclose(
            np.asarray(to.rssi)[np.argsort(to_ord)],
            np.asarray(jo.rssi)[np.argsort(jo_ord)], atol=rssi_atol)
    return jcfg, tcfg, js, ts


C256 = dict(fs_in=256 * 12_000, n_chan=256, chunk_in=256 * 512,
            taps_per=4, n_taps=129)


@pytest.mark.parametrize("pallas_fold,tail,passband", [
    (True, "pallas", "fft"), (True, "xla", "matmul"),
    (False, "pallas", "matmul"), (False, "xla", "fft")])
def test_chan_major_matches_reference(pallas_fold, tail, passband):
    """Chan-major at 256 channels: the fold kernel's route or the plain
    fold, the batched chain's tail kernel (≥ 128 receivers) or its plain
    ops."""
    kw = dict(C256, pallas_fold=pallas_fold, tail_impl=tail,
              passband_impl=passband)
    _, _, js, ts = _compare(kw, _iq(2, C256["chunk_in"]))
    ref = jax.tree_util.tree_leaves(js)
    got = jax.tree_util.tree_leaves(convert.to_numpy(ts))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-3, atol=1e-4)


def test_chan_major_fused_channelizer_matches_reference():
    """`chan_impl="mxu2fused"` on a lane-aligned factoring, chan-major: the
    fused channelizer kernel's route, its planes permuted to bin order."""
    kw = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 256,
              taps_per=4, n_taps=129, chan_impl="mxu2fused",
              chan_precision="highest", passband_impl="matmul",
              tail_impl="pallas")
    _compare(kw, _iq(2, kw["chunk_in"], seed=2))


SMALL = dict(fs_in=192_000, n_chan=16, chunk_in=32_768, taps_per=8,
             n_taps=257)


@pytest.mark.parametrize("kw", [
    dict(SMALL, **jwb.PROFILES["fast"]),
    dict(SMALL, **jwb.PROFILES["quality"]),
    dict(fs_in=1_200_000, n_chan=100, chunk_in=100 * 512,
         **jwb.PROFILES["fast"]),
    dict(fs_in=1_200_000, n_chan=100, chunk_in=100 * 512, mode="USB")],
    ids=["small-fast", "small-quality", "nchan100-fast", "nchan100-usb"])
def test_fallback_tiers_match_reference(kw):
    """SMALL's 16 channels and the CLI's `--n-chan 100`: no lane-aligned
    factoring, so the time-major profiles fall back to the chan-major
    pipeline plus one transpose."""
    tcfg = twb.WidebandConfig(**kw)
    assert not twb._planar_active(tcfg)
    _compare(kw, _iq(2, kw["chunk_in"], seed=7))


PLANAR = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
              taps_per=4, n_taps=129, **jwb.PROFILES["quality"])


@pytest.mark.parametrize("extra,pkw", [
    (dict(hang_enabled=True, hang_ms=60.0), dict(agc_kwargs=dict(hang=True))),
    (dict(squelch_enabled=True),
     dict(squelch_kwargs=dict(enabled=True, thresh_db=-75.0)))],
    ids=["hang", "squelch"])
def test_planar_hang_and_squelch_match_reference(extra, pkw):
    kw = dict(PLANAR, **extra)
    cfg = twb.WidebandConfig(**kw)
    assert twb._planar_active(cfg)
    _, _, js, ts = _compare(kw, _bursty_iq(cfg), pkw, bound=PLANAR_DB,
                            rssi_atol=0.05)
    if extra.get("squelch_enabled"):
        # chunk RSSI ≈ −65 dB, then ≈ −85 dB: the gate opens, then closes
        assert float(ts.chain.squelch.open_.max()) == 0.0
        np.testing.assert_array_equal(
            ts.chain.squelch.open_.numpy(), np.asarray(js.chain.squelch.open_))


def test_process_many_stacks_process_n():
    cfg = twb.WidebandConfig(**C256, pallas_fold=True, tail_impl="pallas")
    p = twb.make_params(cfg, device="cpu")
    iq = _iq(2, cfg.chunk_in, seed=4)
    st = twb.init_state(cfg, device="cpu")
    _, many = twb.process_many(cfg, p, st, iq)
    _, outs = twb.process_n(cfg, p, st, list(iq))
    assert many.shape == (2, cfg.n_chan, cfg.chunk_per_chan * 4)
    assert torch.equal(many, torch.stack(outs))


def test_wideband_config_fields_match_reference():
    """The reference's fields, names and defaults, minus exactly its four
    TPU A/B knobs."""
    import dataclasses
    skip = {"mxu_chan_fft", "chan_fold_dtype", "chan_fft_form",
            "chan_split2"}
    jf = [(f.name, f.default) for f in dataclasses.fields(jwb.WidebandConfig)
          if f.name not in skip]
    tf = [(f.name, f.default) for f in dataclasses.fields(twb.WidebandConfig)]
    assert tf == jf


def test_wideband_params_round_trip():
    """Chan-major JAX params and state → port → numpy, leaf for leaf, and
    the port resumes the reference's stream."""
    kw = dict(C256, pallas_fold=True, tail_impl="pallas", hang_enabled=True,
              squelch_enabled=True)
    jcfg, tcfg = jwb.WidebandConfig(**kw), twb.WidebandConfig(**kw)
    jp = jwb.make_params(jcfg)
    iq = _iq(2, jcfg.chunk_in, seed=6)
    js, _ = jwb.process(jcfg, jp, jwb.init_state(jcfg), iq[0])
    for tree, conv in ((jp, convert.params_from_jax),
                       (js, convert.state_from_jax)):
        back = jax.tree_util.tree_leaves(
            convert.to_numpy(conv(tree, device="cpu")))
        ref = jax.tree_util.tree_leaves(tree)
        assert len(back) == len(ref)
        for a, b in zip(ref, back):
            np.testing.assert_array_equal(np.asarray(a), b)
    _, jo = jwb.process(jcfg, jp, js, iq[1])
    _, to = twb.process(tcfg, convert.params_from_jax(jp, device="cpu"),
                        convert.state_from_jax(js, device="cpu"), iq[1])
    assert _snr(np.asarray(jo.audio), to.audio.numpy()) >= AUDIO_DB
