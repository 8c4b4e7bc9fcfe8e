"""The rest of the port's wideband mesh forms against the JAX package's,
on the CPU: the sharded wideband's time-major and fallback tiers and its
fused controls (NBFM, squelch, AGC hang), the collectives the wideband
pipeline adds (all_to_all, broadcast_last, send_next), the wideband half
of the comm model against the bytes `collectives.traffic` counts, the
distributed FFT, the 2-stage pipeline, ingest and the dry run.

The reference runs under `shard_map` on the virtual CPU devices of
`tests/conftest.py` with its Pallas kernels in interpret mode; the port
runs its meshes on one device through the kernels' plain versions, on the
same seeded numpy inputs and the reference's params (`convert`).
Tolerances, PERF.md §2's: the time-major and fallback tiers ≥ 80 dB, the
planar tier ≥ 45 dB fast and ≥ 85 dB quality, RSSI within 0.05 dB; the
distributed FFT ≤ 1e-4 of the largest bin against numpy (float32 FFTs in
another order); the pipeline rtol and atol 2e-4 (the reference's own
bound against its serial wideband).
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from supersdr_tpu.parallel import comm_model as jcomm
from supersdr_tpu.parallel import pipeline as jpipe
from supersdr_tpu.parallel import sharded_wideband as jsw
from supersdr_tpu.runtime import wideband as jwb
from supersdr_tpu_torch import convert
from supersdr_tpu_torch.ops import cx as tcx
from supersdr_tpu_torch.parallel import collectives
from supersdr_tpu_torch.parallel import comm_model as tcomm
from supersdr_tpu_torch.parallel import dist_fft, dryrun, ingest
from supersdr_tpu_torch.parallel import mesh as tmesh
from supersdr_tpu_torch.parallel import pipeline as tpipe
from supersdr_tpu_torch.parallel import sharded_chain as tsc
from supersdr_tpu_torch.parallel import sharded_wideband as tsw
from supersdr_tpu_torch.runtime import chain as tchain
from supersdr_tpu_torch.runtime import wideband as twb

NF = 512


def _kw(n_chan: int, **extra) -> dict:
    return {**dict(fs_in=n_chan * 12_000, n_chan=n_chan,
                   chunk_in=n_chan * NF, taps_per=4, n_taps=129, mode="AM"),
            **extra}


def _noise(n: int, seed: int, levels=(0.05, 0.05)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([(rng.normal(size=n) + 1j * rng.normal(size=n)) * lv
                     for lv in levels]).astype(np.complex64)


def _fm(n_chan: int, n: int, seed: int = 6):
    """Two chunks of FM carriers at 16 channel centres over a −52 dB floor,
    Carson-safe deviation (bench.py's NBFM gate recipe), and their bins."""
    rng = np.random.default_rng(seed)
    fs = n_chan * 12_000
    t = np.arange(2 * n) / fs
    z = 0.01 * (rng.normal(size=2 * n) + 1j * rng.normal(size=2 * n))
    kbins = rng.choice(n_chan, size=16, replace=False)
    for k in kbins:
        fk = (k if k < n_chan // 2 else k - n_chan) * (fs / n_chan)
        g = rng.uniform(300.0, 1000.0)
        beta = rng.uniform(1.0, 2.5)
        z = z + 0.4 * np.exp(1j * (2 * np.pi * fk * t
                                   + beta * np.sin(2 * np.pi * g * t)))
    return z.astype(np.complex64).reshape(2, n), kbins


def _snr(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _by_bin(audio, order, time_major: bool) -> np.ndarray:
    a = np.asarray(audio)
    return (a.T if time_major else a)[np.argsort(order)]


def _both(cfg_kw, d, iq, wmax=None, pkw=None):
    """The reference's and the port's mesh on the same chunks: per side
    (process, final state, audio by bin, RSSI by bin)."""
    pkw = pkw or {}
    jcfg = jwb.WidebandConfig(**cfg_kw)
    tcfg = twb.WidebandConfig(**cfg_kw)
    jp = jwb.make_params(jcfg, **pkw)
    out = {}
    for side in ("ref", "port"):
        if side == "ref":
            proc = jsw.build(jcfg, jsw.make_mesh(jax.devices()[:d]),
                             planar_waste_max=wmax)
            p, st = jp, jwb.init_state(jcfg)
        else:
            proc = tsw.build(tcfg, tsw.make_mesh(d, device="cpu"),
                             planar_waste_max=wmax)
            p = convert.params_from_jax(jp, device="cpu")
            st = twb.init_state(tcfg, device="cpu")
        audio, rssi = [], []
        for k in range(len(iq)):
            st, a, r = proc(p, st, iq[k])
            audio.append(_by_bin(a, proc.channel_order, tcfg.time_major))
            rssi.append(np.asarray(r)[np.argsort(proc.channel_order)])
        out[side] = (proc, st, audio, rssi)
    return out


# id: (config keywords, shards, planar_waste_max, the port's tier)
TIERS = {
    "tmajor-fir": (_kw(384, **twb.PROFILES["quality"]), 2, 0.0, "tmajor"),
    "fallback-8ch": (dict(fs_in=96_000, n_chan=8, chunk_in=8 * 8 * 128,
                          mode="AM", taps_per=4, n_taps=129), 8, None,
                     "fallback"),
    "fallback-fold-chanmajor": (_kw(256, chunk_in=256 * 256, time_major=False,
                                    pallas_fold=True, tail_impl="pallas",
                                    passband_impl="fft"), 2, None,
                                "fallback"),
}


@pytest.mark.parametrize("case", list(TIERS))
def test_other_tiers_match_reference(case):
    cfg_kw, d, wmax, tier = TIERS[case]
    iq = _noise(cfg_kw["chunk_in"], seed=11)
    out = _both(cfg_kw, d, iq, wmax)
    jproc, _, ja, jr = out["ref"]
    tproc, st, ta, tr = out["port"]
    assert not jproc.planar and tproc.tier == tier
    for k in range(2):
        assert ta[k].shape == ja[k].shape
        assert _snr(ja[k], ta[k]) >= 80.0, (case, k)
        np.testing.assert_allclose(tr[k], jr[k], atol=0.05)


def test_time_major_tier_with_planes_the_tail_cannot_read():
    """4224 channels on 32 shards: 132 channels a shard, not a multiple of
    the FIR tail's 8-channel blocks, so the time-major tier hands the tail
    the 2-D [frames, channels] planes. Against the port's serial planar
    path, through the row orders."""
    cfg = twb.WidebandConfig(**_kw(4224, chunk_in=4224 * 256),
                             **twb.PROFILES["quality"])
    proc = tsw.build(cfg, tsw.make_mesh(32, device="cpu"))
    assert proc.tier == "tmajor"
    p = twb.make_params(cfg, device="cpu")
    iq = _noise(cfg.chunk_in, seed=12)
    _, am, _ = proc.process_n(p, twb.init_state(cfg, device="cpu"), list(iq))
    _, a_s = twb.process_n(cfg, p, twb.init_state(cfg, device="cpu"),
                           list(iq))
    for a, b in zip(am, a_s):
        assert _snr(_by_bin(b, twb.audio_channel_order(cfg), True),
                    _by_bin(a, proc.channel_order, True)) >= 80.0


CONTROLS = {
    # NBFM on FM carriers, manual AGC; compared on the carriers' bins past
    # the FIR and discriminator start-up (bench.py's `_gate_nbfm`)
    "nbfm": (dict(mode="NBFM"), "quality", dict(agc_kwargs=dict(on=False))),
    "squelch": (dict(squelch_enabled=True), "fast",
                dict(squelch_kwargs=dict(enabled=True, thresh_db=-85.0))),
    "hang-40ms": (dict(hang_enabled=True, hang_ms=40.0), "fast",
                  dict(agc_kwargs=dict(hang=True))),
}


@pytest.mark.parametrize("case", list(CONTROLS))
def test_fused_controls_on_the_mesh_match_reference(case):
    extra, prof, pkw = CONTROLS[case]
    cfg_kw = _kw(512, **extra, **twb.PROFILES[prof])
    kbins = None
    if case == "nbfm":
        iq, kbins = _fm(512, cfg_kw["chunk_in"])
    else:       # a loud chunk, then quiet ones the squelch closes on
        iq = _noise(cfg_kw["chunk_in"], seed=13,
                    levels=(0.05, 0.0005, 0.0005))
    out = _both(cfg_kw, 4, iq, pkw=pkw)
    jproc, jst, ja, jr = out["ref"]
    tproc, tst, ta, tr = out["port"]
    assert jproc.planar_factors == tproc.planar_factors == (4, 128, 4)
    tol = 85.0 if prof == "quality" else 45.0
    for k in range(len(iq)):
        r, g = ja[k], ta[k]
        if kbins is not None:
            r = r[kbins, 1280 if k == 0 else 0:]
            g = g[kbins, 1280 if k == 0 else 0:]
        assert _snr(r, g) >= tol, (case, k)
        np.testing.assert_allclose(tr[k], jr[k], atol=0.05)
    np.testing.assert_array_equal(tst.chain.squelch.open_.numpy(),
                                  np.asarray(jst.chain.squelch.open_))
    if case == "squelch":
        assert not tst.chain.squelch.open_.any()


# -------------------------------------------------------------------------
# collectives

@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0), (0, 0), (1, 1)])
def test_all_to_all_is_the_reference_tiled_all_to_all(split, concat):
    d = 4
    x = np.arange(d * 8 * 12, dtype=np.float32).reshape(d * 8, 12)
    jm = JMesh(np.asarray(jax.devices()[:d]), ("x",))
    f = jax.shard_map(
        lambda v: jax.lax.all_to_all(v, "x", split_axis=split,
                                     concat_axis=concat, tiled=True),
        mesh=jm, in_specs=P("x", None), out_specs=P("x", None))
    want = np.asarray(f(jnp.asarray(x)))
    collectives.traffic.reset()
    got = collectives.all_to_all(torch.from_numpy(x).reshape(d, 8, 12),
                                 split, concat)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)
    assert collectives.traffic.a2a_bytes == 8 * 12 * 4 * (d - 1) // d
    assert collectives.traffic.n_collectives == 1


def test_broadcast_last_and_send_next():
    collectives.traffic.reset()
    v = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    b = collectives.broadcast_last(v)
    np.testing.assert_array_equal(b.numpy(), np.tile(v[-1].numpy(), (5, 1)))
    assert collectives.traffic.carry_bytes == 3 * 4
    assert collectives.traffic.n_collectives == 3          # ceil(log2 5)
    s = collectives.send_next(v[:2])
    np.testing.assert_array_equal(s[1].numpy(), v[0].numpy())
    assert not s[0].any()
    assert collectives.traffic.send_bytes == 3 * 4
    assert collectives.traffic.total_bytes == 2 * 3 * 4
    collectives.traffic.reset()
    assert collectives.broadcast_last(v[:1]).shape == (1, 3)
    assert collectives.traffic.total_bytes == 0
    with pytest.raises(ValueError):
        collectives.all_to_all(v, 0, 0)                 # 3 % 5


# -------------------------------------------------------------------------
# the wideband comm model against the counted traffic

# id: (config keywords, shards, int16 chunks, planar_waste_max, tier)
COMM = {
    "planar-512-d4": (_kw(512, **twb.PROFILES["fast"]), 4, False, None,
                      "planar"),
    "planar-384-d2-padded-i16": (_kw(384, **twb.PROFILES["fast"]), 2, True,
                                 None, "planar"),
    "planar-512-d2-quality": (_kw(512, **twb.PROFILES["quality"]), 2, False,
                              None, "planar"),
    "tmajor-384-d2": (_kw(384, **twb.PROFILES["quality"]), 2, False, 0.0,
                      "tmajor"),
    "fallback-8ch-d8": (TIERS["fallback-8ch"][0], 8, False, None,
                        "fallback"),
}


@pytest.mark.parametrize("case", list(COMM))
def test_counted_traffic_equals_the_wideband_model(case):
    cfg_kw, d, i16, wmax, tier = COMM[case]
    cfg = twb.WidebandConfig(**cfg_kw)
    proc = tsw.build(cfg, tsw.make_mesh(d, device="cpu"),
                     planar_waste_max=wmax)
    assert proc.tier == tier
    iq = _noise(cfg.chunk_in, seed=3)[0]
    if i16:
        iq = tuple((p * 32768).astype(np.int16) for p in (iq.real, iq.imag))
    p = twb.make_params(cfg, device="cpu")
    collectives.traffic.reset()
    proc(p, twb.init_state(cfg, device="cpu"), iq)
    t = collectives.traffic
    model = tcomm.wideband_comm_model(cfg, d, i16=i16,
                                      planar_waste_max=wmax)
    assert model["tier"] == tier
    assert t.halo_bytes == model["halo_bytes"]
    assert t.a2a_bytes == model["all_to_all_bytes"]
    assert t.carry_bytes == model["carry_bytes"]
    assert t.total_bytes == model["total_bytes"]
    assert t.n_collectives == model["n_collectives"]


@pytest.mark.parametrize("n_chan,d,prof", [(2560, 8, "fast"),
                                           (2560, 4, "fast"),
                                           (2560, 2, "quality"),
                                           (512, 4, "fast"), (384, 2, "fast"),
                                           (8, 8, None)])
def test_wideband_model_equals_the_reference_where_factorings_agree(
        n_chan, d, prof):
    kw = (_kw(n_chan, chunk_in=n_chan * 16128 if n_chan == 2560
              else n_chan * NF, **twb.PROFILES[prof]) if prof
          else TIERS["fallback-8ch"][0])
    got = tcomm.wideband_comm_model(twb.WidebandConfig(**kw), d)
    want = jcomm.wideband_comm_model(jwb.WidebandConfig(**kw), d)
    for key in ("halo_bytes", "all_to_all_bytes", "carry_bytes",
                "total_bytes", "planar", "pad_frac"):
        assert got[key] == want[key], key
    if (n_chan, d) == (2560, 8):
        # 24 planes of 128 channels × 2016 frames, two bf16 planes, 7/8 out
        assert got["all_to_all_bytes"] == 24 * 128 * 2016 * 2 * 2 * 7 // 8
        assert got["pad_frac"] == pytest.approx(0.2)


# -------------------------------------------------------------------------
# distributed FFT, pipeline, ingest, dry run

@pytest.mark.parametrize("d", [2, 4, 8])
def test_dist_fft_matches_numpy(d):
    n = 8192
    rng = np.random.default_rng(d)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    m = dist_fft.make_mesh(d, device="cpu")
    collectives.traffic.reset()
    y = dist_fft.build_fft(n, m)(x)
    assert collectives.traffic.n_collectives == 1       # one transpose
    assert collectives.traffic.a2a_bytes == (n // d) * 8 * (d - 1) // d
    got = y.re.numpy() + 1j * y.im.numpy()
    want = np.fft.fft(x)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4
    back = dist_fft.build_fft(n, m, sign=+1)(y)
    np.testing.assert_allclose(back.re.numpy() + 1j * back.im.numpy(), x,
                               atol=2e-4)
    with pytest.raises(ValueError):
        dist_fft.build_fft(n + d, m)


PIPE = dict(fs_in=96_000, n_chan=8, chunk_in=16384, mode="AM", taps_per=8,
            n_taps=129)


def _pipe_iq(n_mb: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    t = np.arange(n_mb * PIPE["chunk_in"]) / PIPE["fs_in"]
    iq = (0.4 * (1 + 0.6 * np.cos(2 * np.pi * 500 * t))
          * np.exp(2j * np.pi * 12000 * t)
          + 0.01 * (rng.normal(size=len(t)) + 1j * rng.normal(size=len(t))))
    return iq.astype(np.complex64).reshape(n_mb, PIPE["chunk_in"])


def test_pipeline_matches_reference():
    """Two microbatches through both packages' 2-stage pipelines, AGC off
    (as the reference's own pipeline test)."""
    agc_off = dict(agc_kwargs=dict(on=False, man_gain_db=50.0))
    jcfg = jwb.WidebandConfig(**PIPE)
    jp = jwb.make_params(jcfg, **agc_off)
    mbs = _pipe_iq(2)
    jst, ja = jpipe.build(jcfg, jpipe.make_mesh(jax.devices()[:2]))(
        jp, jwb.init_state(jcfg), mbs)
    tcfg = twb.WidebandConfig(**PIPE)
    collectives.traffic.reset()
    tst, ta = tpipe.build(tcfg, tpipe.make_mesh("cpu"))(
        convert.params_from_jax(jp, device="cpu"),
        twb.init_state(tcfg, device="cpu"), mbs)
    assert tuple(ta.shape) == (2, 8, 16384 // 8 * 4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(tst.pfb_carry.re.numpy(),
                                  np.asarray(jst.pfb_carry.re))
    # one handoff a step: M + 1 steps, one fill and one drain bubble
    assert collectives.traffic.n_collectives == 3
    assert collectives.traffic.send_bytes == 3 * 8 * 16384 // 8 * 4 * 4


def test_pipeline_equals_the_serial_wideband_with_the_agc_on():
    """The port's stage 1 idles in the fill bubble, so its chain state sees
    the microbatches alone and the pipeline is the serial wideband."""
    cfg = twb.WidebandConfig(**PIPE)
    p = twb.make_params(cfg, device="cpu")
    mbs = _pipe_iq(3)
    st, audio = tpipe.build(cfg, tpipe.make_mesh("cpu"))(
        p, twb.init_state(cfg, device="cpu"), mbs)
    sst, outs = twb.process_n(cfg, p, twb.init_state(cfg, device="cpu"),
                              list(mbs))
    for k in range(3):
        np.testing.assert_array_equal(audio[k].numpy(), outs[k].numpy())
    np.testing.assert_array_equal(st.chain.agc.gain_db.numpy(),
                                  sst.chain.agc.gain_db.numpy())
    with pytest.raises(ValueError):
        tpipe.build(cfg, tsw.make_mesh(4, device="cpu"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_ingest_in_one_process():
    m = tmesh.time_mesh(8, device="cpu")
    n = 8 * 1024
    assert ingest.local_time_range(n, m) == (0, n)
    ingest.initialize_distributed()                     # no coordinator
    t = np.arange(n) / 12000
    iq = np.exp(2j * np.pi * 800 * t).astype(np.complex64)[None, :]
    g = ingest.make_global_iq(iq, iq.shape, m)
    assert tuple(g.shape) == (1, 8, 1024) and g.device.type == "cpu"
    cfg = tchain.ChainConfig(mode="USB", chunk=1024, os_block=1024,
                             n_taps=129)
    proc = tsc.build(cfg, m)
    _, out = proc(tsc.make_params(cfg, 1, device="cpu"),
                  tsc.init_state(cfg, 1, device="cpu"), g.flatten(-2))
    audio = out.audio.numpy()
    assert audio.shape == (1, n * 4)
    assert np.abs(audio[0, 8000:]).max() > 0.1
    with pytest.raises(ValueError):
        ingest.make_global_iq(iq[:, :-1], iq.shape, m)
    # one gloo process over localhost: still one process's whole range
    import torch.distributed as dist
    ingest.initialize_distributed(f"localhost:{_free_port()}", 1, 0)
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert ingest.local_time_range(n, m) == (0, n)
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_on_eight_shards():
    line = dryrun.dryrun_multichip(8, device="cpu")
    assert line.startswith("dryrun_multichip OK on 8 shards")
