"""Every channelizer and passband variant of the JAX package on the port,
against the reference on the CPU.

The routes: the `chan_impl` knockouts "stub" and "nofft", the `mxu2`
family ("mxu2" with a float16 fold, "mxu2conv", "mxu2pallas", the "dit"
DFT form), "legacy" with `mxu_chan_fft`, and `passband_impl="fftmxu"`.
Both packages take the same seeded numpy IQ through two (wideband) or
three (chain) chained chunks; the reference's Pallas kernels (the fold,
the non-FIR tail) run in interpret mode, the port's wrappers their plain
versions.

Tolerances: audio SNR ≥ 80 dB (float32 against float32; the DC pole and
the AGC amplify summation-order differences, as in
tests/test_torch_wideband_chanmajor.py), also at `chan_precision` /
`passband_precision` "default": the reference rounds its DFT products to
bf16 only on a TPU, and on the CPU runs them in float32 as the port does
(45 dB is the bound against a TPU); ≥ 45 dB for the planar "fast"
profile, whose bf16 operands both packages round. "stub" is bit-exact at
the channelizer, and the float16 fold agrees with the reference's to
float32 rounding of a K-term sum. RSSI within 0.01 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.ops import channelizer as jch
from supersdr_tpu.parallel import mesh as jmesh
from supersdr_tpu.parallel import sharded_chain as jsc
from supersdr_tpu.parallel import sharded_wideband as jsw
from supersdr_tpu.runtime import chain as jchain
from supersdr_tpu.runtime import wideband as jwb
from supersdr_tpu_torch import convert
from supersdr_tpu_torch.ops import channelizer as tch
from supersdr_tpu_torch.ops import cx as tcx
from supersdr_tpu_torch.ops.cuda import pfb_fold as tpf
from supersdr_tpu_torch.parallel import mesh as tmesh
from supersdr_tpu_torch.parallel import sharded_chain as tsc
from supersdr_tpu_torch.parallel import sharded_wideband as tsw
from supersdr_tpu_torch.runtime import chain as tchain
from supersdr_tpu_torch.runtime import wideband as twb

HIGH_DB = 80.0
FAST_DB = 45.0
RSSI_DB = 0.01

C256 = dict(fs_in=256 * 12_000, n_chan=256, chunk_in=256 * 512,
            taps_per=4, n_taps=129)

ROUTES = {
    "stub": dict(chan_impl="stub"),
    "nofft": dict(chan_impl="nofft"),
    "mxu2-f16": dict(chan_impl="mxu2", chan_fold_dtype="f16"),
    "mxu2conv": dict(chan_impl="mxu2conv"),
    "mxu2pallas": dict(chan_impl="mxu2pallas"),
    "dit": dict(chan_impl="mxu2", chan_fft_form="dit"),
    "legacy-mxu-fft": dict(chan_impl="legacy", mxu_chan_fft=True),
}


def _snr(ref, got):
    ref = np.asarray(ref, np.complex128)
    got = np.asarray(got, np.complex128)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _iq(shape, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
            * 0.05).astype(np.complex64)


def _wideband_both(kw, iq):
    """Both packages' `wideband.process` over the chunks of iq; yields
    (reference output, port output) a chunk."""
    jcfg, tcfg = jwb.WidebandConfig(**kw), twb.WidebandConfig(**kw)
    jp, tp = jwb.make_params(jcfg), twb.make_params(tcfg, device="cpu")
    js, ts = jwb.init_state(jcfg), twb.init_state(tcfg, device="cpu")
    for chunk in iq:
        js, jo = jwb.process(jcfg, jp, js, chunk)
        ts, to = twb.process(tcfg, tp, ts, chunk)
        yield jo, to


@pytest.mark.parametrize("prec", ["highest", "default"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_route_matches_reference(route, prec):
    """Each chan-major route at 256 channels, the ≥ 128-receiver tail
    (`tail_impl="pallas"`) behind it."""
    kw = dict(C256, tail_impl="pallas", chan_precision=prec,
              **ROUTES[route])
    for k, (jo, to) in enumerate(
            _wideband_both(kw, _iq((2, C256["chunk_in"]), 11))):
        assert to.audio.shape == jo.audio.shape
        snr = _snr(jo.audio, to.audio.numpy())
        assert snr >= HIGH_DB, (k, snr)
        np.testing.assert_allclose(to.rssi.numpy(), np.asarray(jo.rssi),
                                   atol=RSSI_DB)


def _dispatch_both(kw, carry, x):
    jcfg, tcfg = jwb.WidebandConfig(**kw), twb.WidebandConfig(**kw)
    jc, jchans = jwb.channelize_dispatch(jcfg, jwb.make_params(jcfg),
                                         jnp.asarray(carry), jnp.asarray(x))
    tc, tchans = twb.channelize_dispatch(
        tcfg, twb.make_params(tcfg, device="cpu"),
        tcx.as_cx(carry, device="cpu"), tcx.as_cx(x, device="cpu"))
    return (np.asarray(jc), np.asarray(jchans),
            tc.re.numpy() + 1j * tc.im.numpy(), tchans.numpy())


def test_stub_is_bit_exact_at_the_channelizer():
    """The knockout's channels are the chunk reshaped and transposed, its
    carry the one passed in, in both packages."""
    plan = twb.pfb_plan(twb.WidebandConfig(**C256))
    carry = _iq(plan.history, 3)
    x = _iq(C256["chunk_in"], 4)
    jc, jchans, tc, tchans = _dispatch_both(dict(C256, chan_impl="stub"),
                                            carry, x)
    assert tchans.shape == jchans.shape == (256, 512)
    np.testing.assert_array_equal(tchans, jchans)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tc, carry)


@pytest.mark.parametrize("route", ["nofft", "mxu2-f16"])
def test_float16_fold_matches_reference(route):
    """The float16 fold (input rounded to nearest even, float32 products
    and sums): "nofft" returns it untransformed, compared to float32
    rounding of the K-term sum; the carry is exact."""
    plan = twb.pfb_plan(twb.WidebandConfig(**C256))
    carry = _iq(plan.history, 5)
    x = _iq(C256["chunk_in"], 6)
    jc, jchans, tc, tchans = _dispatch_both(dict(C256, **ROUTES[route]),
                                            carry, x)
    np.testing.assert_array_equal(tc, jc)
    peak = np.abs(jchans).max()
    np.testing.assert_allclose(tchans, jchans, rtol=0,
                               atol=(2e-7 if route == "nofft" else 2e-5)
                               * peak)
    # and the rounding is there: the float32 fold differs
    _, f32, _, _ = _dispatch_both(dict(C256, chan_impl="mxu2"), carry, x)
    if route == "mxu2-f16":
        assert np.abs(f32 - jchans).max() > 1e-4 * peak


def test_mxu2pallas_runs_the_fold_wrapper(monkeypatch):
    """`mxu2pallas` reaches the fold kernel's wrapper once a chunk (its
    plain version on the CPU, which counts no launch); an M off the
    128 lanes takes the slice fold, as the reference's."""
    calls = []
    real = tpf.pfb_fold

    def spy(plan, G, carry, x):
        calls.append(tuple(G.shape))
        return real(plan, G, carry, x)
    monkeypatch.setattr(tpf, "pfb_fold", spy)
    cfg = twb.WidebandConfig(**C256, chan_impl="mxu2pallas")
    twb.process_n(cfg, twb.make_params(cfg, device="cpu"),
                  twb.init_state(cfg, "cpu"),
                  list(_iq((2, cfg.chunk_in), 8)))
    small = twb.WidebandConfig(fs_in=96 * 12_000, n_chan=96,
                               chunk_in=96 * 64, taps_per=4, n_taps=129,
                               chan_impl="mxu2pallas")
    twb.process(small, twb.make_params(small, device="cpu"),
                twb.init_state(small, "cpu"), _iq(small.chunk_in, 9))
    assert calls == [(4, 256), (4, 256)]
    assert real.launches == 0


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_conv_fold_refuses_float16(pkg):
    """The reference's check: the depthwise conv fold runs in float32 and
    refuses a float16 fold dtype instead of ignoring it."""
    plan, proto = jch.design(256, 4)
    x = _iq(256 * 8, 1)
    if pkg == "ref":
        with pytest.raises(ValueError, match="float32"):
            jch.channelize_mxu2_c(plan, jch.taps_matrix(plan, proto),
                                  jnp.zeros(plan.history, jnp.complex64),
                                  jnp.asarray(x), fold_impl="conv",
                                  fold_dtype=jnp.float16)
        return
    with pytest.raises(ValueError, match="float32"):
        tch.channelize_mxu2_c(plan, tch.taps_matrix(plan, proto),
                              torch.zeros(plan.history,
                                          dtype=torch.complex64),
                              torch.from_numpy(x), fold_impl="conv",
                              fold_dtype=torch.float16)


@pytest.mark.parametrize("fold", ["slices", "conv", "pallas"])
def test_mxu2_channelizer_refuses_a_batch_as_the_reference(fold):
    """`channelize_mxu2_c` is unbatched in both packages (ValueError);
    the port's `channelize_mxu2_n` takes the batch the mesh gives it and
    equals the unbatched call row for row."""
    plan, proto = tch.design(256, 4)
    W = tch.taps_matrix(plan, proto)
    carry = torch.from_numpy(_iq((2, plan.history), 2))
    x = torch.from_numpy(_iq((2, 256 * 8), 3))
    with pytest.raises(ValueError, match="unbatched"):
        tch.channelize_mxu2_c(plan, W, carry, x, fold_impl=fold)
    with pytest.raises(ValueError, match="unbatched"):
        jch.channelize_mxu2_c(plan, jch.taps_matrix(plan, proto),
                              jnp.asarray(carry.numpy()),
                              jnp.asarray(x.numpy()), fold_impl=fold)
    c2, y2 = tch.channelize_mxu2_n(plan, W, carry, x, fold_impl=fold)
    for d in range(2):
        c1, y1 = tch.channelize_mxu2_c(plan, W, carry[d], x[d],
                                       fold_impl=fold)
        assert torch.equal(c2[d], c1)
        torch.testing.assert_close(y2[d], y1, rtol=0, atol=1e-6)


@pytest.mark.parametrize("split", ["auto", "on", "off"])
@pytest.mark.parametrize("profile", ["fast", "quality"])
def test_chan_split2_bin_ordered_audio_matches(profile, split):
    """The reference's own case (test_wideband.py's split test): the
    planar pipeline over two chunks at 512 channels, compared in bin
    order through each package's `audio_channel_order`. The port keeps
    stage B unsplit whatever `chan_split2` says."""
    kw = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 256,
              mode="AM", taps_per=8, n_taps=257, chan_split2=split,
              **jwb.PROFILES[profile])
    jcfg, tcfg = jwb.WidebandConfig(**kw), twb.WidebandConfig(**kw)
    assert jwb._planar_active(jcfg) and twb._planar_active(tcfg)
    np.testing.assert_array_equal(
        twb.audio_channel_order(tcfg),
        twb.audio_channel_order(twb.WidebandConfig(
            **dict(kw, chan_split2="off"))))
    jinv = np.argsort(jwb.audio_channel_order(jcfg))
    tinv = np.argsort(twb.audio_channel_order(tcfg))
    bound = FAST_DB if profile == "fast" else 85.0
    for k, (jo, to) in enumerate(
            _wideband_both(kw, _iq((2, kw["chunk_in"]), 17))):
        snr = _snr(np.asarray(jo.audio)[:, jinv],
                   to.audio.float().numpy()[:, tinv])
        assert snr >= bound, (k, snr)


def test_chan_split2_is_checked_as_the_reference():
    for mod in (jwb, twb):
        with pytest.raises(ValueError, match="chan_split2"):
            mod.WidebandConfig(chan_split2="yes")


CHAIN = dict(iq_rate=12_000, chunk=512, os_block=512, passband_impl="fftmxu")
FFTMXU_CASES = {
    # a batch of three, an overlap (200) that is not a power of two
    "usb-b3-201taps": (dict(CHAIN, mode="USB", n_taps=201), (3,), "highest"),
    "am-256-tail-high": (dict(CHAIN, mode="AM", n_taps=257,
                              tail_impl="pallas"), (256,), "high"),
    "lsb-default": (dict(CHAIN, mode="LSB", n_taps=129), (2,), "default"),
}


@pytest.mark.parametrize("case", list(FFTMXU_CASES))
def test_fftmxu_passband_matches_reference(case):
    """`passband_impl="fftmxu"`: the one-row overlap-save through three
    chained `chain.process` calls."""
    kw, batch, prec = FFTMXU_CASES[case]
    kw = dict(kw, passband_precision=prec)
    jcfg, tcfg = jchain.ChainConfig(**kw), tchain.ChainConfig(**kw)
    offs = np.linspace(-300.0, 300.0, batch[0])
    jp = jchain.make_params(jcfg, freq_offset_hz=offs)
    tp = tchain.make_params(tcfg, freq_offset_hz=offs, device="cpu")
    js = jchain.init_state(jcfg, batch)
    ts = tchain.init_state(tcfg, batch, device="cpu")
    iq = _iq(batch + (3 * jcfg.chunk,), 23)
    for k in range(3):
        x = iq[..., k * jcfg.chunk:(k + 1) * jcfg.chunk]
        js, jo = jchain.process(jcfg, jp, js, x)
        ts, to = tchain.process(tcfg, tp, ts, x)
        assert to.rssi.shape == batch + (1,)
        snr = _snr(jo.audio, to.audio.numpy())
        assert snr >= HIGH_DB, (k, snr)
        np.testing.assert_allclose(to.rssi.numpy(), np.asarray(jo.rssi),
                                   atol=RSSI_DB)
        bb = to.baseband.re.numpy() + 1j * to.baseband.im.numpy()
        assert _snr(np.asarray(jo.baseband.re)
                    + 1j * np.asarray(jo.baseband.im), bb) >= HIGH_DB
    # the carried history: the NCO-mixed input (mixers round alike to
    # float32's last bits)
    np.testing.assert_allclose(ts.os_carry.re.numpy(),
                               np.asarray(js.os_carry.re), rtol=0,
                               atol=1e-7)


def test_fftmxu_run_offline_matches_reference():
    kw = dict(mode="AM", iq_rate=12_000, chunk=1024, os_block=1024,
              passband_impl="fftmxu")
    jcfg, tcfg = jchain.ChainConfig(**kw), tchain.ChainConfig(**kw)
    iq = _iq(3 * 1024 + 333, 29) + 0.3
    _, ja, jr = jchain.run_offline(jcfg, jchain.make_params(jcfg), iq)
    _, ta, tr = tchain.run_offline(
        tcfg, tchain.make_params(tcfg, device="cpu"), iq)
    assert ta.shape == ja.shape
    assert _snr(ja, ta) >= HIGH_DB
    np.testing.assert_allclose(tr, jr, atol=RSSI_DB)


def test_sharded_chain_fftmxu_matches_reference():
    """The sharded chain with `fftmxu`: the reference's body takes the
    overlap-save branch with the halo head for it, and so does the
    port's (the halo kernel's wrapper, its plain version here)."""
    kw = dict(mode="USB", iq_rate=12_000, chunk=1024, os_block=1024,
              passband_impl="fftmxu")
    iq = _iq((2, 1024 * 4), 31) + 0.2
    jcfg, tcfg = jchain.ChainConfig(**kw), tchain.ChainConfig(**kw)
    jm = jmesh.make_mesh(n_chan=1, n_time=4, devices=jax.devices()[:4])
    _, jo = jsc.build(jcfg, jm)(jsc.make_params(jcfg, n_chan=2),
                                jsc.init_state(jcfg, 2), jnp.asarray(iq))
    tm = tmesh.make_mesh(n_chan=1, n_time=4, device="cpu", n_shards=4)
    ts, to = tsc.build(tcfg, tm)(tsc.make_params(tcfg, 2, device="cpu"),
                                 tsc.init_state(tcfg, 2, device="cpu"), iq)
    assert _snr(np.asarray(jo.audio), to.audio.numpy()) >= HIGH_DB
    np.testing.assert_allclose(to.rssi.numpy(), np.asarray(jo.rssi),
                               atol=RSSI_DB)


@pytest.mark.parametrize("route", ["stub", "nofft", "mxu2conv",
                                   "mxu2pallas"])
def test_sharded_wideband_runs_each_route(route):
    """The mesh's fallback tier runs every route the reference's mesh
    runs: on 4 shards against the reference's mesh, and against the
    port's serial pipeline, with the next call's PFB history the input's
    tail (the reference's, also where "stub" passes its carry through)."""
    kw = dict(C256, tail_impl="pallas", **ROUTES[route])
    jcfg, tcfg = jwb.WidebandConfig(**kw), twb.WidebandConfig(**kw)
    iq = _iq(C256["chunk_in"], 37)
    jproc = jsw.build(jcfg, jsw.make_mesh(jax.devices()[:4]))
    jp = jwb.make_params(jcfg)
    jst, ja, jr = jproc(jp, jwb.init_state(jcfg), iq)
    tproc = tsw.build(tcfg, tsw.make_mesh(4, device="cpu"))
    assert tproc.tier == "fallback"
    tp = convert.params_from_jax(jp, device="cpu")
    tst, ta, tr = tproc(tp, twb.init_state(tcfg, device="cpu"), iq)
    assert _snr(ja, ta.numpy()) >= HIGH_DB
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=RSSI_DB)
    np.testing.assert_array_equal(tst.pfb_carry.re.numpy(),
                                  np.asarray(jst.pfb_carry.re))
    _, so = twb.process(tcfg, tp, twb.init_state(tcfg, device="cpu"), iq)
    assert _snr(so.audio.numpy(), ta.numpy()) >= HIGH_DB


REF_VALUES = [
    dict(chan_impl=v) for v in ("legacy", "mxu2", "mxu2conv", "mxu2pallas",
                                "mxu2fused", "stub", "nofft")] + [
    dict(chan_split2=v) for v in ("auto", "on", "off")] + [
    dict(chan_fold_dtype="f16"), dict(chan_fft_form="dit"),
    dict(mxu_chan_fft=True), dict(passband_impl="fftmxu")]


@pytest.mark.parametrize("kw", REF_VALUES,
                         ids=["-".join(map(str, *k.items()))
                              for k in REF_VALUES])
def test_every_reference_value_builds_the_port_config(kw):
    """A keyword the reference's config accepts builds the port's, with
    the same chain config behind it."""
    import dataclasses
    jcfg, tcfg = jwb.WidebandConfig(**kw), twb.WidebandConfig(**kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.chain_cfg) \
        == dataclasses.asdict(jcfg.chain_cfg)


def test_cli_wideband_fftmxu_runs_end_to_end(tmp_path, capsys):
    """`cli wideband --passband fftmxu`, which the CLI offers, runs to its
    end in both packages and writes the same channels, the same audio."""
    from supersdr_tpu import cli as jcli
    from supersdr_tpu_torch import cli as tcli
    from supersdr_tpu_torch.io import wav
    n_chan, fs = 8, 8 * 12_000
    plan, _ = tch.design(n_chan, 8)
    freqs = tch.channel_center_freqs(plan, fs)
    n = n_chan * 1536 + 1024
    t = np.arange(n) / fs
    z = 0.4 * (1 + 0.6 * np.cos(2 * np.pi * 500 * t)) \
        * np.exp(2j * np.pi * freqs[3] * t) + _iq(n, 41) * 0.04
    src = str(tmp_path / "wide.wav")
    wav.write_kiwi_iq_wav(src, z.astype(np.complex64), fs)
    got = {}
    for name, mod, extra in (("ref", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        out = tmp_path / name
        assert mod.main(["wideband", src, "-o", str(out), "--n-chan",
                         str(n_chan), "--top", "2", "--passband",
                         "fftmxu"] + extra) == 0
        got[name] = {p.name: wav.read_audio_wav(p)[0]
                     for p in out.glob("*.wav")}
    assert got["port"].keys() == got["ref"].keys()
    assert len(got["ref"]) == 2
    for name, ref in got["ref"].items():
        assert _snr(ref, got["port"][name]) >= HIGH_DB, name
