"""The port's mesh-sharded receiver chain against the JAX package's, on
the CPU (mirrors tests/test_sharded_chain.py).

The reference runs `sharded_chain.build` under `shard_map` on the 8
virtual CPU devices; the port runs its mesh on one device, the shards on
an explicit tensor axis. Both get the same seeded numpy IQ and params
from the same keywords, and the port's sharded chain is also held against
its own serial `chain.process` on the whole capture.

Tolerances: audio rtol 2e-3, atol 2e-4, the reference's own bound for
sharded against serial (float32; the two-level scans re-associate the
recurrences, and the AGC's exp of a dB sum amplifies that), against the
port's serial chain and against the reference's sharded chain alike;
atol 1e-3 across chained calls. RSSI within 0.01 dB. One exception,
against the other package only: the first RAMP = 1280 audio samples of a
stream with the fft passband are held to atol 1e-3. While that filter
ramps up from its zero history its output is the FFT's rounding noise
(~1e-7 of the input, and the two packages' FFTs round differently), which
the AGC, then at its full 70 dB of gain, lifts to ~3e-4.
`test_matmul_passband_meets_the_bound_from_the_first_sample` shows the
cause: with the matmul passband, where no FFT runs, the same stream meets
atol 2e-4 from sample 0. With the squelch on, the sharded gate is per
shard, so it is compared with the reference's sharded chain only. NBFM's
discriminator takes the angle of that rounding noise, so on the ramp-up
it is not compared with the other package at all (bench.py's `_gate_nbfm`
skips the same 1280 samples); with the AGC on, the AGC holds that angle
noise for its decay, and the comparison starts after NBFM_AGC_SKIP = 4096
samples; from sample 0 NBFM is held against the port's serial chain,
which shares its FFT."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.parallel import comm_model as jcomm
from supersdr_tpu.parallel import mesh as jmesh
from supersdr_tpu.parallel import sharded_chain as jsharded
from supersdr_tpu.runtime import chain as jchain
from supersdr_tpu_torch.ops.cuda import halo as thalo
from supersdr_tpu_torch.parallel import collectives
from supersdr_tpu_torch.parallel import comm_model as tcomm
from supersdr_tpu_torch.parallel import mesh as tmesh
from supersdr_tpu_torch.parallel import sharded_chain as tsharded
from supersdr_tpu_torch.runtime import chain as tchain

AGC_ON = dict(on=True, thresh_db=-80, decay_ms=1000)
AUDIO_TOL = dict(rtol=2e-3, atol=2e-4)
RAMP_TOL = dict(rtol=2e-3, atol=1e-3)   # other package, fft passband ramp-up
RAMP = 1280                             # audio samples
NBFM_AGC_SKIP = 4096
RSSI_TOL = dict(atol=0.01)


def make_iq(n, n_chan=1, seed=0, fs=12000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    out = []
    for c in range(n_chan):
        tone = np.exp(2j * np.pi * (800 + 400 * c) * t)
        noise = 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
        out.append(tone + noise)
    return np.stack(out).astype(np.complex64)


def _audio(out):
    a = out.audio
    if hasattr(a, "re"):
        return np.asarray(a.re) + 1j * np.asarray(a.im)
    return np.asarray(a)


def _run_ref(cfg_kw, n_chan, grid, iqs, offsets=0.0, **pkw):
    """The reference's sharded chain over `grid` = (chan, time) shards,
    one call per array of `iqs`."""
    cfg = jchain.ChainConfig(**cfg_kw)
    m = jmesh.make_mesh(n_chan=grid[0], n_time=grid[1],
                        devices=jax.devices()[:grid[0] * grid[1]])
    proc = jsharded.build(cfg, m)
    p = jsharded.make_params(cfg, n_chan=n_chan, freq_offsets_hz=offsets,
                             **pkw)
    st = jsharded.init_state(cfg, n_chan)
    outs = []
    for iq in iqs:
        st, out = proc(p, st, jnp.asarray(iq))
        outs.append(out)
    return st, outs


def _run_port(cfg_kw, n_chan, grid, iqs, offsets=0.0, halo_impl="rdma",
              **pkw):
    cfg = tchain.ChainConfig(**cfg_kw)
    m = tmesh.make_mesh(n_chan=grid[0], n_time=grid[1], device="cpu",
                        n_shards=grid[0] * grid[1])
    proc = tsharded.build(cfg, m, halo_impl=halo_impl)
    p = tsharded.make_params(cfg, n_chan, offsets, **pkw, device="cpu")
    st = tsharded.init_state(cfg, n_chan, device="cpu")
    outs = []
    for iq in iqs:
        st, out = proc(p, st, iq)
        outs.append(out)
    return st, outs


def _run_serial(cfg_kw, n_chan, n_time, iqs, offsets=0.0, **pkw):
    """The port's serial chain on each whole capture (chunk = the call's
    length, os_block = the shard length)."""
    cfg = tchain.ChainConfig(**dict(cfg_kw, chunk=cfg_kw["chunk"] * n_time,
                                    os_block=cfg_kw["chunk"]))
    offs = np.broadcast_to(np.asarray(offsets, np.float64), (n_chan,))
    p = tchain.make_params(cfg, freq_offset_hz=offs, **pkw, device="cpu")
    st = tchain.init_state(cfg, (n_chan,), device="cpu")
    outs = []
    for iq in iqs:
        st, out = tchain.process(cfg, p, st, iq)
        outs.append(out)
    return st, outs


def _close(got, ref, skip=0, stop=None, **tol):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_audio(g)[..., skip:stop],
                                   _audio(r)[..., skip:stop], **tol)
        np.testing.assert_allclose(np.asarray(g.rssi), np.asarray(r.rssi),
                                   **RSSI_TOL)


def _close_to_ref(got, ref, cfg_kw, skip=RAMP):
    """Against the other package: the bound past the ramp-up; on it the
    matmul passband meets the bound too, the fft passband RAMP_TOL, and
    NBFM is not compared."""
    _close(got, ref, skip=skip, **AUDIO_TOL)
    if cfg_kw["mode"] != "NBFM":
        head = AUDIO_TOL if cfg_kw.get("passband_impl") == "matmul" \
            else RAMP_TOL
        _close(got[:1], ref[:1], stop=skip, **head)


# (id, config keywords, receivers, (chan, time) grid, offsets, params
#  keywords, compare with the serial chain too)
CASES = [
    ("usb", dict(mode="USB", chunk=2048, os_block=2048), 1, (1, 8), 0.0,
     dict(agc_kwargs=AGC_ON), True),
    ("am", dict(mode="AM", chunk=2048, os_block=2048), 1, (1, 8), 0.0,
     dict(agc_kwargs=AGC_ON), True),
    ("nbfm", dict(mode="NBFM", chunk=2048, os_block=2048), 1, (1, 8), 0.0,
     dict(agc_kwargs=dict(on=False)), True),
    ("cw", dict(mode="CW", chunk=2048, os_block=2048), 1, (1, 8), 0.0,
     dict(agc_kwargs=AGC_ON), True),
    ("grid-2x4-offsets", dict(mode="USB", chunk=2048, os_block=2048), 4,
     (2, 4), np.array([0.0, 200.0, -150.0, 500.0]),
     dict(agc_kwargs=AGC_ON), True),
    ("am-matmul", dict(mode="AM", chunk=1024, os_block=1024,
                       passband_impl="matmul"), 2, (1, 8), 0.0,
     dict(agc_kwargs=AGC_ON), True),
    ("iq", dict(mode="IQ", chunk=1024, os_block=1024), 2, (1, 8), 0.0,
     dict(agc_kwargs=AGC_ON), True),
    ("am-hang", dict(mode="AM", chunk=1024, os_block=1024,
                     hang_enabled=True, hang_ms=40.0), 1, (1, 8), 0.0,
     dict(agc_kwargs=dict(AGC_ON, hang=True)), True),
    ("usb-hang-fills-shard", dict(mode="USB", chunk=1024, os_block=1024,
                                  hang_enabled=True, hang_ms=85.0), 2,
     (1, 8), 0.0, dict(agc_kwargs=dict(AGC_ON, hang=True)), True),
    ("am-squelch", dict(mode="AM", chunk=1024, os_block=1024,
                        squelch_enabled=True), 2, (1, 8), 0.0,
     dict(agc_kwargs=AGC_ON,
          squelch_kwargs=dict(enabled=True, thresh_db=-20.0)), False),
    ("am-two-rows", dict(mode="AM", chunk=2048, os_block=1024), 1, (1, 4),
     0.0, dict(agc_kwargs=AGC_ON), False),
]


@pytest.mark.parametrize("cfg_kw,n_chan,grid,offsets,pkw,serial",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_sharded_chain_matches_reference(cfg_kw, n_chan, grid, offsets, pkw,
                                         serial):
    iq = make_iq(cfg_kw["chunk"] * grid[1], n_chan)
    st_p, out_p = _run_port(cfg_kw, n_chan, grid, [iq], offsets, **pkw)
    st_r, out_r = _run_ref(cfg_kw, n_chan, grid, [iq], offsets, **pkw)
    _close_to_ref(out_p, out_r, cfg_kw)
    np.testing.assert_allclose(np.asarray(out_p[0].baseband.re),
                               np.asarray(out_r[0].baseband.re),
                               rtol=1e-3, atol=1e-4)
    # the returned stream state is the reference's, leaf for leaf
    np.testing.assert_allclose(st_p.phase.numpy(), np.asarray(st_r.phase),
                               atol=1e-6)
    np.testing.assert_allclose(st_p.os_carry.re.numpy(),
                               np.asarray(st_r.os_carry.re), atol=1e-5)
    np.testing.assert_allclose(st_p.agc.gain_db.numpy(),
                               np.asarray(st_r.agc.gain_db), atol=1e-3)
    np.testing.assert_allclose(st_p.interp_carry.numpy(),
                               np.asarray(st_r.interp_carry), **AUDIO_TOL)
    np.testing.assert_array_equal(st_p.squelch.open_.numpy(),
                                  np.asarray(st_r.squelch.open_))
    if serial:
        _, out_s = _run_serial(cfg_kw, n_chan, grid[1], [iq], offsets,
                               **pkw)
        _close(out_p, out_s, **AUDIO_TOL)


@pytest.mark.parametrize("mode", ["AM", "USB"])
def test_matmul_passband_meets_the_bound_from_the_first_sample(mode):
    """The reading behind RAMP_TOL: the stream that needs atol 1e-3 on its
    ramp-up with the fft passband meets 2e-4 from sample 0 with the matmul
    passband, where neither package runs an FFT; so the ramp-up difference
    is the two FFTs' rounding, not the sharded chain."""
    iq = make_iq(2048 * 8, 1)
    kw = dict(mode=mode, chunk=2048, os_block=2048, passband_impl="matmul")
    _, out_p = _run_port(kw, 1, (1, 8), [iq], agc_kwargs=AGC_ON)
    _, out_r = _run_ref(kw, 1, (1, 8), [iq], agc_kwargs=AGC_ON)
    _close(out_p, out_r, **AUDIO_TOL)


def test_nbfm_with_agc_matches_reference_past_the_ramp_up():
    kw = dict(mode="NBFM", chunk=2048, os_block=2048)
    iq = make_iq(2048 * 8, 2, seed=2)
    st_p, out_p = _run_port(kw, 2, (1, 8), [iq], agc_kwargs=AGC_ON)
    st_r, out_r = _run_ref(kw, 2, (1, 8), [iq], agc_kwargs=AGC_ON)
    _close(out_p, out_r, skip=NBFM_AGC_SKIP, **AUDIO_TOL)
    np.testing.assert_allclose(st_p.agc.gain_db.numpy(),
                               np.asarray(st_r.agc.gain_db), atol=1e-3)


def test_nbfm_with_agc_sharded_equals_serial():
    kw = dict(mode="NBFM", chunk=2048, os_block=2048)
    iq = make_iq(2048 * 8, 2, seed=2)
    st_p, out_p = _run_port(kw, 2, (1, 8), [iq], agc_kwargs=AGC_ON)
    st_s, out_s = _run_serial(kw, 2, 8, [iq], agc_kwargs=AGC_ON)
    _close(out_p, out_s, **AUDIO_TOL)
    for a, b in zip(st_p.demod.last_sample, st_s.demod.last_sample):
        assert torch.equal(a, b)
    np.testing.assert_allclose(st_p.agc.peak_db.numpy(),
                               st_s.agc.peak_db.numpy(), atol=1e-3)


@pytest.mark.parametrize("passband", ["fft", "matmul"])
def test_streaming_state_chains_across_calls(passband):
    """Two consecutive sharded calls equal the reference's, and one long
    serial run of the port's chain."""
    local, n_time = 1024, 8
    n = local * n_time
    iq = make_iq(2 * n, n_chan=1, seed=3)
    kw = dict(mode="AM", chunk=local, os_block=local, passband_impl=passband)
    calls = [iq[:, :n], iq[:, n:]]
    _, out_p = _run_port(kw, 1, (1, n_time), calls, agc_kwargs=AGC_ON)
    _, out_r = _run_ref(kw, 1, (1, n_time), calls, agc_kwargs=AGC_ON)
    _close(out_p, out_r, rtol=2e-3, atol=1e-3)
    _, out_s = _run_serial(dict(kw, chunk=2 * local), 1, n_time, [iq],
                           agc_kwargs=AGC_ON)
    audio = np.concatenate([_audio(o) for o in out_p], axis=-1)
    np.testing.assert_allclose(audio, _audio(out_s[0]), rtol=2e-3, atol=1e-3)


def test_time_sharded_rational_rate():
    """20250 → 48000 under time sharding: the stuffed-domain halo rebuilds
    the serial carry."""
    local, n_time = 2025, 8
    n = local * n_time
    rng = np.random.default_rng(5)
    t = np.arange(n) / 20250
    iq = (np.exp(2j * np.pi * 900 * t)
          + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
          )[None].astype(np.complex64)
    kw = dict(mode="USB", iq_rate=20250, audio_rate=48000, chunk=local,
              os_block=local)
    st_p, out_p = _run_port(kw, 1, (1, n_time), [iq], agc_kwargs=AGC_ON)
    st_r, out_r = _run_ref(kw, 1, (1, n_time), [iq], agc_kwargs=AGC_ON)
    _close_to_ref(out_p, out_r, kw)
    np.testing.assert_allclose(st_p.interp_carry.numpy(),
                               np.asarray(st_r.interp_carry), **AUDIO_TOL)
    _, out_s = _run_serial(kw, 1, n_time, [iq], agc_kwargs=AGC_ON)
    _close(out_p, out_s, **AUDIO_TOL)


def test_halo_impls_agree_and_count_no_launch_on_cpu():
    kw = dict(mode="NBFM", chunk=1024, os_block=1024)
    iq = make_iq(1024 * 4, 2, seed=9)
    before = thalo.left_halo.launches
    _, a = _run_port(kw, 2, (1, 4), [iq], halo_impl="rdma")
    _, b = _run_port(kw, 2, (1, 4), [iq], halo_impl="ppermute")
    assert torch.equal(a[0].audio, b[0].audio)
    assert thalo.left_halo.launches == before


def test_build_refuses_what_the_reference_refuses():
    m = tmesh.time_mesh(4, device="cpu")
    cfg = tchain.ChainConfig(chunk=1024, os_block=1024,
                             passband_impl="matmul_real")
    with pytest.raises(ValueError, match="serial-only"):
        tsharded.build(cfg, m)
    with pytest.raises(ValueError, match="serial-only"):
        jsharded.build(jchain.ChainConfig(chunk=1024, os_block=1024,
                                          passband_impl="matmul_real"),
                       jmesh.make_mesh(n_chan=2, n_time=4))
    with pytest.raises(ValueError, match="halo_impl"):
        tsharded.build(tchain.ChainConfig(), m, halo_impl="nccl")
    proc = tsharded.build(tchain.ChainConfig(chunk=1024, os_block=1024), m)
    cfg = tchain.ChainConfig(chunk=1024, os_block=1024)
    with pytest.raises(ValueError, match="iq must be"):
        proc(tsharded.make_params(cfg, 1, device="cpu"),
             tsharded.init_state(cfg, 1, device="cpu"),
             np.zeros((1, 1024 * 3), np.complex64))


def test_default_devices_agree_and_a_mismatch_raises():
    """`build(cfg, make_mesh(...))` with mesh, params and state on one
    device runs; params on another device raise."""
    cfg = tchain.ChainConfig(chunk=1024, os_block=1024)
    m = tmesh.make_mesh(1, 4, device="cpu")
    p = tsharded.make_params(cfg, 1, device="cpu")
    st = tsharded.init_state(cfg, 1, device="cpu")
    assert tmesh.default_device(p.P_interp.device) == m.device
    assert tmesh.default_device(st.phase.device) == m.device
    _, out = tsharded.build(cfg, m)(p, st, make_iq(1024 * 4))
    assert out.audio.device.type == m.device.type
    other = tmesh.Mesh(1, 4, torch.device("cuda", 1))
    with pytest.raises(ValueError, match="params lie on"):
        tsharded.build(cfg, other)(
            tsharded.make_params(cfg, 1, device="cpu"),
            tsharded.init_state(cfg, 1, device="cpu"), make_iq(1024 * 4))
    assert tmesh.default_device("cpu") == torch.device("cpu")


def test_make_mesh_validates_like_the_reference():
    m = tmesh.make_mesh(n_time=4, device="cpu", n_shards=8)
    assert (m.n_chan, m.n_time) == (2, 4)
    assert m.shape == {tmesh.CHAN_AXIS: 2, tmesh.TIME_AXIS: 4}
    assert m.shape == dict(jmesh.make_mesh(n_time=4).shape)
    assert tmesh.make_mesh(device="cpu", n_shards=8).n_chan == 8
    assert tmesh.time_mesh(8, device="cpu").shape == dict(
        jmesh.time_mesh().shape)
    with pytest.raises(ValueError, match="3x4 != 8"):
        tmesh.make_mesh(3, 4, device="cpu", n_shards=8)
    with pytest.raises(ValueError, match="3x4 != 8"):
        jmesh.make_mesh(3, 4)
    with pytest.raises(ValueError, match="positive"):
        tmesh.make_mesh(0, 4, device="cpu")


COMM_CASES = [
    ("am", dict(mode="AM")), ("usb", dict(mode="USB")),
    ("nbfm", dict(mode="NBFM")), ("iq", dict(mode="IQ")),
    ("am-hang", dict(mode="AM", hang_enabled=True, hang_ms=40.0)),
    ("usb-rational", dict(mode="USB", iq_rate=20250, audio_rate=48000)),
]


@pytest.mark.parametrize("kw", [c[1] for c in COMM_CASES],
                         ids=[c[0] for c in COMM_CASES])
def test_counted_bytes_equal_the_model_and_ignore_the_chunk(kw):
    """What `collectives` counts for one call equals the chain model, per
    time shard, and does not grow with the shard length (compute grows,
    communication does not: tests/test_comm_model.py is the model)."""
    n_time, n_chan = 8, 3
    rate = kw.get("iq_rate", 12000)
    seen = []
    for chunk in ((2025, 4050) if rate == 20250 else (1024, 4096)):
        cfg_kw = dict(kw, chunk=chunk, os_block=chunk)
        iq = make_iq(chunk * n_time, n_chan, fs=rate)
        collectives.traffic.reset()
        _run_port(cfg_kw, n_chan, (1, n_time), [iq],
                  agc_kwargs=dict(hang=kw.get("hang_enabled", False)))
        t = collectives.traffic
        model = tcomm.chain_comm_model(tchain.ChainConfig(**cfg_kw), n_time,
                                       n_chan_local=n_chan)
        assert t.halo_bytes == model["halo_bytes"]
        assert t.summary_bytes == model["summary_bytes"]
        assert t.total_bytes == model["total_bytes"]
        # the reference's model charges 8 bytes a channel for the
        # neighbour sample in every mode; the port's what the mode moves
        ref = jcomm.chain_comm_model(jchain.ChainConfig(**cfg_kw), n_time,
                                     n_chan_local=n_chan)
        assert 0 <= ref["total_bytes"] - model["total_bytes"] <= 8 * n_chan
        seen.append((t.total_bytes, t.n_collectives))
    assert seen[0] == seen[1]
    assert seen[0][1] < 16


def test_projection_takes_its_link_numbers_as_arguments():
    cfg = tchain.ChainConfig(mode="AM", chunk=16128, os_block=16128,
                             n_taps=257)
    model = tcomm.chain_comm_model(cfg, n_time=8, n_chan_local=2560)
    assert tcomm.NVLINK_GBPS == 450.0
    eff = tcomm.scaling_efficiency(0.01, model["total_bytes"])
    assert eff == pytest.approx(jcomm.scaling_efficiency(
        0.01, model["total_bytes"], ici_gbps=450.0))
    t = tcomm.comm_time_ab(12, model["total_bytes"], alpha_s=5e-6)
    assert t == pytest.approx(jcomm.comm_time_ab(
        12, model["total_bytes"], alpha_s=5e-6, ici_gbps=450.0))
    assert tcomm.scaling_efficiency_ab(
        0.01, 12, model["total_bytes"], alpha_s=5e-6, hops=2
    ) == pytest.approx(jcomm.scaling_efficiency_ab(
        0.01, 12, model["total_bytes"], alpha_s=5e-6, ici_gbps=450.0,
        hops=2))
    with pytest.raises(TypeError):
        tcomm.comm_time_ab(12, model["total_bytes"])   # α has no default
