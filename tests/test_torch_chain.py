"""The port's receiver chain against the JAX package's, on the CPU.

Each case builds both packages' params from the same keywords (each with
its own `make_params`), runs the same seeded numpy IQ through three
chained `chain.process` calls, and compares audio, RSSI and the final
state. Batches of 256 receivers with `tail_impl="pallas"` run the
reference's `_process_tail_pallas` (its `chain_tail_am` kernel in Pallas
interpret mode) against the port's tail wrapper on CPU tensors, its plain
version.

Tolerances: audio SNR ≥ 80 dB — both are float32, and the DC pole
(1/(1 − 0.999) = 1000× gain on a rounding step) and the AGC's exp of a dB
sum amplify summation-order differences (FFTs, matmuls, scans) to ~1e-5
relative; RSSI within 0.01 dB (a mean of |y|² in another order); state
leaves within rtol 1e-3, atol 1e-4 (the same amplification on dB-scale
and audio-scale leaves). NBFM follows bench.py's `_gate_nbfm`:
Carson-safe FM carriers, AGC manual, the first 1280 audio samples
skipped (the discriminator's angle on the FIR ramp-up is ill-conditioned).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.runtime import chain as jchain
from supersdr_tpu.runtime import dualrx as jdualrx
from supersdr_tpu_torch import convert
from supersdr_tpu_torch.ops import cx as tcx
from supersdr_tpu_torch.runtime import chain as tchain

AUDIO_DB = 80.0
RSSI_DB = 0.01
NBFM_SKIP = 1280
N_CHUNKS = 3


def _snr(ref, got):
    ref = np.asarray(ref, np.complex128)
    got = np.asarray(got, np.complex128)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _iq(batch, n, fs, mode, seed):
    """Seeded IQ [*batch, n]: AM carriers with a bursty envelope (so AGC,
    hang and squelch act) over noise, or FM carriers for NBFM."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    shape = batch + (n,)
    noise = 0.003 * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
    f_c = rng.uniform(-0.1, 0.1, size=batch + (1,)) * fs
    if mode == "NBFM":
        g = rng.uniform(300.0, 1000.0, size=batch + (1,))
        beta = rng.uniform(1.0, 2.5, size=batch + (1,))
        z = 0.4 * np.exp(1j * (2 * np.pi * f_c * t
                               + beta * np.sin(2 * np.pi * g * t)))
    else:
        burst = (np.sin(2 * np.pi * 3.0 * t) > 0.3).astype(np.float64)
        env = 0.3 * (1 + 0.6 * np.sin(2 * np.pi * 700.0 * t)) * (
            0.1 + 0.9 * burst)
        z = env * np.exp(2j * np.pi * f_c * t)
    z = z + noise
    z[..., n // 3] += 3.0                       # one impulse (blanker)
    return z.astype(np.complex64)


BASE = dict(iq_rate=12_000, chunk=512, os_block=512, n_taps=257)
RATIONAL = dict(iq_rate=20_250, chunk=1080, os_block=1080, n_taps=257)

# (id, config keywords, batch, make_params keywords)
CASES = [
    ("am-fft-einsum", dict(BASE, mode="AM"), (), {}),
    ("usb-matmul-fma-b2", dict(BASE, mode="USB", passband_impl="matmul",
                               resample_impl="fma"), (2,), {}),
    ("lsb-matmulreal-matmul", dict(BASE, mode="LSB",
                                   passband_impl="matmul_real",
                                   resample_impl="matmul"), (), {}),
    ("am-matmulreal", dict(BASE, mode="AM", passband_impl="matmul_real"),
     (), {}),
    ("cw-fft", dict(BASE, mode="CW"), (), {}),
    ("nbfm-fft", dict(BASE, mode="NBFM"), (), dict(agc_kwargs=dict(on=False))),
    ("iq-fft", dict(BASE, mode="IQ"), (2,), {}),
    ("am-rational-20k25", dict(RATIONAL, mode="AM"), (), {}),
    ("usb-rational-matmul", dict(RATIONAL, mode="USB",
                                 passband_impl="matmul"), (2,), {}),
    ("am-hang", dict(BASE, mode="AM", hang_enabled=True, hang_ms=20.0), (),
     dict(agc_kwargs=dict(hang=True))),
    ("am-squelch", dict(BASE, mode="AM", squelch_enabled=True), (2,),
     dict(squelch_kwargs=dict(enabled=True, thresh_db=-40.0))),
    ("am-blanker", dict(BASE, mode="AM", blanker_enabled=True), (),
     dict(blanker_kwargs=dict(enabled=True, thresh_ratio=4.0))),
    ("am-agc-dec8", dict(BASE, mode="AM", agc_decimation=8), (), {}),
    ("am-pallas-256", dict(BASE, mode="AM", passband_impl="matmul",
                           tail_impl="pallas"), (256,), {}),
    ("usb-pallas-256-hang-squelch",
     dict(BASE, mode="USB", tail_impl="pallas", hang_enabled=True,
          hang_ms=40.0, squelch_enabled=True), (256,),
     dict(agc_kwargs=dict(hang=True),
          squelch_kwargs=dict(enabled=True, thresh_db=-40.0))),
    ("nbfm-pallas-256", dict(BASE, mode="NBFM", tail_impl="pallas"), (256,),
     dict(agc_kwargs=dict(on=False))),
]


def _leaves_close(ref_tree, port_tree, skip_peak=False):
    """State leaves within the stated tolerance. skip_peak (NBFM): the
    tracked peak holds the ramp-up transient's ill-conditioned angles for
    the 4 s decay; with AGC manual it does not reach the audio."""
    if skip_peak:
        ref_tree = ref_tree._replace(agc=ref_tree.agc._replace(
            peak_db=jnp.zeros_like(ref_tree.agc.peak_db)))
        port_tree = port_tree._replace(agc=port_tree.agc._replace(
            peak_db=torch.zeros_like(port_tree.agc.peak_db)))
    ref = [np.asarray(v) for v in jax.tree_util.tree_leaves(ref_tree)]
    got = jax.tree_util.tree_leaves(convert.to_numpy(port_tree))
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)


def _run_both(kw, batch, pkw, seed=3):
    jcfg = jchain.ChainConfig(**kw)
    tcfg = tchain.ChainConfig(**kw)
    offs = np.linspace(-300.0, 300.0, int(np.prod(batch))).reshape(batch) \
        if batch else 120.0
    jp = jchain.make_params(jcfg, freq_offset_hz=offs, **pkw)
    tp = tchain.make_params(tcfg, freq_offset_hz=offs, **pkw, device="cpu")
    js = jchain.init_state(jcfg, batch)
    ts = tchain.init_state(tcfg, batch, device="cpu")
    iq = _iq(batch, N_CHUNKS * jcfg.chunk, jcfg.iq_rate, jcfg.mode, seed)
    outs = []
    for k in range(N_CHUNKS):
        x = iq[..., k * jcfg.chunk:(k + 1) * jcfg.chunk]
        js, jo = jchain.process(jcfg, jp, js, x)
        ts, to = tchain.process(tcfg, tp, ts, x)
        outs.append((jo, to))
    return jcfg, js, ts, outs


@pytest.mark.parametrize("kw,batch,pkw", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_process_matches_reference(kw, batch, pkw):
    jcfg, js, ts, outs = _run_both(kw, batch, pkw)
    for k, (jo, to) in enumerate(outs):
        ref = np.asarray(jo.audio)         # a CX converts to complex
        got = (to.audio.re.numpy() + 1j * to.audio.im.numpy()
               if isinstance(to.audio, tcx.CX) else to.audio.numpy())
        assert got.shape == ref.shape
        if jcfg.mode == "NBFM" and k == 0:
            ref, got = ref[..., NBFM_SKIP:], got[..., NBFM_SKIP:]
        snr = _snr(ref, got)
        assert snr >= AUDIO_DB, (k, snr)
        np.testing.assert_allclose(to.rssi.numpy(), np.asarray(jo.rssi),
                                   atol=RSSI_DB)
    _leaves_close(js, ts, skip_peak=jcfg.mode == "NBFM")


def test_multi_runtime_modes_match_reference():
    """MULTI: per-slot modes, passbands, offsets and AGC, stacked by the
    reference's dual-RX builder and carried into the port by
    `convert.chain_params_from_jax`."""
    cfg_kw = dict(BASE, mode="MULTI", squelch_enabled=True)
    jcfg = jchain.ChainConfig(**cfg_kw)
    tcfg = tchain.ChainConfig(**cfg_kw)
    slots = [("AM", -6000.0, 6000.0, 150.0, dict(decay_ms=1000.0)),
             ("NBFM", -6000.0, 6000.0, -420.0, dict(on=False))]
    plist = [jchain.make_params(dataclasses.replace(jcfg, mode=m),
                                freq_offset_hz=f, low_cut=lc, high_cut=hc,
                                agc_kwargs=ag)
             for m, lc, hc, f, ag in slots]
    jp = jdualrx._stack_params(plist, [s[0] for s in slots])
    tp = convert.chain_params_from_jax(jp, device="cpu")
    assert tp.mode_id.dtype == torch.int32
    iq = _iq((2,), N_CHUNKS * jcfg.chunk, jcfg.iq_rate, "AM", 9)
    js = jchain.init_state(jcfg, (2,))
    ts = tchain.init_state(tcfg, (2,), device="cpu")
    for k in range(N_CHUNKS):
        x = iq[..., k * jcfg.chunk:(k + 1) * jcfg.chunk]
        js, jo = jchain.process(jcfg, jp, js, x)
        ts, to = tchain.process(tcfg, tp, ts, x)
        ref, got = np.asarray(jo.audio), to.audio.numpy()
        assert _snr(ref[0], got[0]) >= AUDIO_DB
        np.testing.assert_allclose(to.rssi.numpy(), np.asarray(jo.rssi),
                                   atol=RSSI_DB)
    _leaves_close(js, ts, skip_peak=True)


@pytest.mark.parametrize("rate,chunk", [(12_000, 2048), (20_250, 2025)])
def test_run_offline_matches_reference(rate, chunk):
    """One receiver through `run_offline` (the demod CLI's path): an
    input length that is not a chunk multiple, default n_taps 513."""
    kw = dict(mode="AM", iq_rate=rate, chunk=chunk, os_block=chunk)
    jcfg, tcfg = jchain.ChainConfig(**kw), tchain.ChainConfig(**kw)
    iq = _iq((), 3 * chunk + 777, rate, "AM", 21)
    _, ja, jr = jchain.run_offline(jcfg, jchain.make_params(jcfg), iq)
    ts, ta, tr = tchain.run_offline(
        tcfg, tchain.make_params(tcfg, device="cpu"), iq)
    assert ta.shape == ja.shape
    assert _snr(ja, ta) >= AUDIO_DB
    np.testing.assert_allclose(tr, jr, atol=RSSI_DB)


def test_chain_config_fields_match_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jchain.ChainConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tchain.ChainConfig)]
    assert tf == jf


@pytest.mark.parametrize("kw", [dict(chunk=1000, os_block=512),
                                dict(n_taps=256),
                                dict(passband_impl="fir"),
                                dict(passband_impl="fftmxu", chunk=1024,
                                     os_block=512),
                                dict(iq_rate=20_250, chunk=1000,
                                     os_block=1000)])
def test_chain_config_checks_match_reference(kw):
    with pytest.raises(ValueError):
        jchain.ChainConfig(**kw)
    with pytest.raises(ValueError):
        tchain.ChainConfig(**kw)


def test_chain_params_fields_match_reference():
    assert tchain.ChainParams._fields == jchain.ChainParams._fields
    assert tchain.ChainState._fields == jchain.ChainState._fields
    assert tchain.ChainOutput._fields == jchain.ChainOutput._fields


@pytest.mark.parametrize("kw", [
    dict(BASE, mode="USB", passband_impl="matmul_real",
         resample_impl="matmul"),
    dict(RATIONAL, mode="AM", passband_impl="matmul")])
def test_make_params_equal_converted_reference(kw):
    """The port's own params equal the reference's carried across by
    `convert`, leaf for leaf (float32, bit for bit)."""
    jp = jchain.make_params(jchain.ChainConfig(**kw), freq_offset_hz=75.0)
    tp = tchain.make_params(tchain.ChainConfig(**kw), freq_offset_hz=75.0,
                            device="cpu")
    conv = convert.chain_params_from_jax(jp, device="cpu")
    a = jax.tree_util.tree_leaves(convert.to_numpy(tp))
    b = jax.tree_util.tree_leaves(convert.to_numpy(conv))
    assert len(a) == len(b) == len(jax.tree_util.tree_leaves(jp))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_chain_params_and_state_round_trip():
    """JAX params and state → port → numpy give back the reference's
    leaves, and the port resumes the reference's stream."""
    kw = dict(BASE, mode="USB", passband_impl="matmul_real", hang_enabled=True,
              squelch_enabled=True)
    jcfg, tcfg = jchain.ChainConfig(**kw), tchain.ChainConfig(**kw)
    jp = jchain.make_params(jcfg, freq_offset_hz=np.array([40.0, -90.0]),
                            agc_kwargs=dict(hang=True))
    iq = _iq((2,), 2 * jcfg.chunk, jcfg.iq_rate, "USB", 4)
    js, _ = jchain.process(jcfg, jp, jchain.init_state(jcfg, (2,)),
                           iq[..., :jcfg.chunk])
    for tree, conv in ((jp, convert.chain_params_from_jax),
                       (js, convert.chain_state_from_jax)):
        back = jax.tree_util.tree_leaves(
            convert.to_numpy(conv(tree, device="cpu")))
        ref = jax.tree_util.tree_leaves(tree)
        assert len(back) == len(ref)
        for a, b in zip(ref, back):
            np.testing.assert_array_equal(np.asarray(a), b)
    tp = convert.chain_params_from_jax(jp, device="cpu")
    js2, jo = jchain.process(jcfg, jp, js, iq[..., jcfg.chunk:])
    ts2, to = tchain.process(
        tcfg, tp, convert.chain_state_from_jax(js, device="cpu"),
        iq[..., jcfg.chunk:])
    assert _snr(np.asarray(jo.audio), to.audio.numpy()) >= AUDIO_DB
    _leaves_close(js2, ts2)
    # and the reference resumes the port's state
    leaves = [jnp.asarray(v) for v in
              jax.tree_util.tree_leaves(convert.to_numpy(ts2))]
    jst = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(js2),
                                       leaves)
    _, jo3 = jchain.process(jcfg, jp, jst, iq[..., :jcfg.chunk])
    _, to3 = tchain.process(tcfg, tp, ts2, iq[..., :jcfg.chunk])
    assert _snr(np.asarray(jo3.audio), to3.audio.numpy()) >= AUDIO_DB


def test_fftmxu_passband_raises():
    """`passband_impl="fftmxu"` raised here until the reference's one-row
    overlap-save was ported; now it runs and matches the reference's
    audio, RSSI and state (tests/test_torch_variants.py adds batches,
    precisions, run_offline and the mesh)."""
    kw = dict(BASE, mode="AM", passband_impl="fftmxu")
    jcfg, js, ts, outs = _run_both(kw, (2,), {})
    for k, (jo, to) in enumerate(outs):
        snr = _snr(np.asarray(jo.audio), to.audio.numpy())
        assert snr >= AUDIO_DB, (k, snr)
        np.testing.assert_allclose(to.rssi.numpy(), np.asarray(jo.rssi),
                                   atol=RSSI_DB)
    _leaves_close(js, ts)
