"""The port's sharded wideband pipeline (planar tier) against the JAX
package's, on the CPU.

The reference runs `sharded_wideband.build` under `shard_map` on the
virtual CPU devices of `tests/conftest.py`, its Pallas kernels in
interpret mode; the port runs its mesh on one device, the shards on a
leading tensor axis, through the kernels' plain versions. Both take the
same seeded numpy chunks and the reference's params (carried across by
`convert`), two chunks chained, and are compared through each side's
`process.channel_order` (row → PFB bin).

Tolerances, PERF.md §2's: audio SNR ≥ 45 dB on the fast profile (bf16
planes and operands, rounded at other places) and ≥ 85 dB on quality
(both ~float32; the reference's split-bf16 ×3 products set the floor),
RSSI within 0.05 dB. The port's 1- and 2-shard meshes run the serial
factoring and kernel program and are held bit-identical to the port's own
serial `wideband.process_n`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.ops import channelizer as jch
from supersdr_tpu.ops import cx as jcx
from supersdr_tpu.ops.pallas import channelize_fused as jcf
from supersdr_tpu.parallel import sharded_wideband as jsw
from supersdr_tpu.runtime import wideband as jwb
from supersdr_tpu_torch import convert
from supersdr_tpu_torch.ops import channelizer as tch
from supersdr_tpu_torch.ops import cx as tcx
from supersdr_tpu_torch.ops.cuda import channelize_fused as tcf
from supersdr_tpu_torch.parallel import sharded_wideband as tsw
from supersdr_tpu_torch.runtime import wideband as twb

NF = 512                      # frames a chunk
SNR_MIN = {"fast": 45.0, "quality": 85.0}
RSSI_ATOL = 0.05


def _kw(n_chan: int, **extra) -> dict:
    return {**dict(fs_in=n_chan * 12_000, n_chan=n_chan,
                   chunk_in=n_chan * NF, taps_per=4, n_taps=129, mode="AM"),
            **extra}


def _chunks(n: int, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n)))
            * 0.05).astype(np.complex64)


def _snr(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _by_bin(audio_t, order) -> np.ndarray:
    """[T·L, C] audio rows → [C, T·L] in PFB bin order."""
    return np.asarray(audio_t).T[np.argsort(order)]


# id: (n_chan, shards, profile, planar_waste_max, planar factors)
CASES = {
    "512-d2-fast": (512, 2, "fast", None, (2, 256, 2)),
    "512-d4-fast": (512, 4, "fast", None, (4, 128, 4)),
    "384-d2-padded": (384, 2, "fast", None, (3, 128, 4)),
    "640-d8-waste-1": (640, 8, "fast", 1.0, (5, 128, 8)),
    "512-d4-quality": (512, 4, "quality", None, (4, 128, 4)),
}


@pytest.fixture(scope="module")
def ref_runs():
    """The reference mesh's two chained chunks per case, on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            n_chan, d, prof, wmax, _ = CASES[case]
            cfg = jwb.WidebandConfig(**_kw(n_chan), **jwb.PROFILES[prof])
            proc = jsw.build(cfg, jsw.make_mesh(jax.devices()[:d]),
                             planar_waste_max=wmax)
            p = jwb.make_params(cfg)
            st = jwb.init_state(cfg)
            iq = _chunks(cfg.chunk_in)
            audio, rssi = [], []
            for k in range(2):
                st, a, r = proc(p, st, iq[k])
                audio.append(_by_bin(a, proc.channel_order))
                rssi.append(np.asarray(r)[np.argsort(proc.channel_order)])
            cache[case] = dict(proc=proc, params=p, state=st, iq=iq,
                               audio=audio, rssi=rssi)
        return cache[case]
    return get


def _port(case, params, iq, **kw):
    n_chan, d, prof, wmax, _ = CASES[case]
    cfg = twb.WidebandConfig(**_kw(n_chan), **twb.PROFILES[prof])
    proc = tsw.build(cfg, tsw.make_mesh(d, device="cpu"),
                     planar_waste_max=wmax)
    p = convert.params_from_jax(params, device="cpu")
    st = twb.init_state(cfg, device="cpu")
    audio, rssi = [], []
    for k in range(2):
        st, a, r = proc(p, st, iq[k])
        audio.append(_by_bin(a, proc.channel_order))
        rssi.append(r.numpy()[np.argsort(proc.channel_order)])
    return proc, st, audio, rssi


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_matches_reference(ref_runs, case):
    ref = ref_runs(case)
    n_chan, d, prof, _, factors = CASES[case]
    proc, st, audio, rssi = _port(case, ref["params"], ref["iq"])
    assert ref["proc"].planar and proc.planar
    assert ref["proc"].planar_factors == proc.planar_factors == factors
    for k in range(2):
        assert audio[k].shape == ref["audio"][k].shape == (n_chan, NF * 4)
        snr = _snr(ref["audio"][k], audio[k])
        assert snr >= SNR_MIN[prof], (case, k, snr)
        np.testing.assert_allclose(rssi[k], ref["rssi"][k], atol=RSSI_ATOL)
    # the stream state leaving the mesh is the serial wideband's, bin order
    jst = ref["state"]
    np.testing.assert_array_equal(st.pfb_carry.re.numpy(),
                                  np.asarray(jst.pfb_carry.re))
    np.testing.assert_allclose(st.chain.agc.gain_db.numpy(),
                               np.asarray(jst.chain.agc.gain_db), atol=1e-3)
    np.testing.assert_allclose(st.chain.os_carry.re.numpy(),
                               np.asarray(jst.chain.os_carry.re),
                               atol=2e-3 if prof == "fast" else 1e-5)


def _serial_and_mesh(n_chan, d, prof, iqs, **cfg_kw):
    cfg = twb.WidebandConfig(**_kw(n_chan, **cfg_kw), **twb.PROFILES[prof])
    p = twb.make_params(cfg, device="cpu")
    proc = tsw.build(cfg, tsw.make_mesh(d, device="cpu"))
    st_m, a_m, r_m = proc.process_n(p, twb.init_state(cfg, device="cpu"),
                                    iqs)
    st_s, a_s = twb.process_n(cfg, p, twb.init_state(cfg, device="cpu"),
                              iqs)
    return cfg, proc, (st_m, a_m, r_m), (st_s, a_s)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("prof", ["fast", "quality"])
def test_one_and_two_shards_are_the_serial_path_bit_for_bit(d, prof):
    iq = _chunks(512 * NF, seed=5)
    cfg, proc, (st_m, a_m, _), (st_s, a_s) = _serial_and_mesh(
        512, d, prof, list(iq))
    assert proc.planar_factors == (2, 256, 2)
    np.testing.assert_array_equal(proc.channel_order,
                                  twb.audio_channel_order(cfg))
    for a, b in zip(a_m, a_s):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(jax.tree.leaves(convert.to_numpy(st_m.chain)),
                    jax.tree.leaves(convert.to_numpy(st_s.chain))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(st_m.pfb_carry.re.numpy(),
                                  st_s.pfb_carry.re.numpy())


def _quantize(z: np.ndarray):
    return tuple(np.clip(np.round(p * 32768.0), -32768, 32767)
                 .astype(np.int16) for p in (z.real, z.imag))


def test_int16_ingest_matches_the_dequantized_chunk():
    """int16 chunks go to the channelizer as they are and the halo moves
    int16 samples; the audio is the dequantized float32 chunk's."""
    iq = _chunks(384 * NF, seed=7)
    q = [_quantize(z) for z in iq]
    deq = [tcx.CX(*(torch.from_numpy(p.astype(np.float32) / 32768.0)
                    for p in c)) for c in q]
    cfg = twb.WidebandConfig(**_kw(384), **twb.PROFILES["fast"])
    proc = tsw.build(cfg, tsw.make_mesh(2, device="cpu"))
    assert proc.planar_factors == (3, 128, 4)
    p = twb.make_params(cfg, device="cpu")
    _, a16, r16 = proc.process_n(p, twb.init_state(cfg, device="cpu"), q)
    _, a32, r32 = proc.process_n(p, twb.init_state(cfg, device="cpu"), deq)
    for a, b in zip(a16, a32):
        assert _snr(b.numpy(), a.numpy()) >= 80.0
    np.testing.assert_allclose(r16.numpy(), r32.numpy(), atol=1e-4)


def test_process_n_equals_chained_calls_and_mixes_kinds():
    iq = _chunks(384 * NF, seed=9)
    cfg = twb.WidebandConfig(**_kw(384), **twb.PROFILES["quality"])
    proc = tsw.build(cfg, tsw.make_mesh(2, device="cpu"))
    p = twb.make_params(cfg, device="cpu")
    st0 = twb.init_state(cfg, device="cpu")
    st_n, audios, rssi = proc.process_n(p, st0, list(iq))
    st, a0, _ = proc(p, st0, iq[0])
    st, a1, r1 = proc(p, st, iq[1])
    np.testing.assert_array_equal(audios[0].numpy(), a0.numpy())
    np.testing.assert_array_equal(audios[1].numpy(), a1.numpy())
    np.testing.assert_array_equal(rssi.numpy(), r1.numpy())
    for a, b in zip(convert.to_numpy(st_n), convert.to_numpy(st)):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # an int16 chunk then a complex tensor chunk, in one call
    q = _quantize(iq[0])
    mixed = [q, torch.from_numpy(iq[1])]
    _, am, _ = proc.process_n(p, st0, mixed)
    deq = tcx.CX(*(torch.from_numpy(v.astype(np.float32) / 32768.0)
                   for v in q))
    _, ad, _ = proc.process_n(p, st0, [deq, torch.from_numpy(iq[1])])
    for a, b in zip(am, ad):
        assert a.shape == (NF * 4, 384)
        assert _snr(b.numpy(), a.numpy()) >= 80.0


def test_factorings_match_the_reference_and_honour_chan_factors():
    """The tier and factoring the mesh picks, against the reference's, over
    shard counts and channel counts; then the two reference faults the port
    does not copy (ROADMAP queue 3): the reference's mesh ignores
    `chan_factors`, and prefers n2 = 512 on its quality tier whatever the
    serial factoring is."""
    for n_chan in (256, 384, 512, 640, 1024, 2560):
        for d in (1, 2, 4, 8):
            kw = _kw(n_chan, chunk_in=n_chan * 128)
            jcfg = jwb.WidebandConfig(**kw, **jwb.PROFILES["fast"])
            tcfg = twb.WidebandConfig(**kw, **twb.PROFILES["fast"])
            if n_chan % d:
                continue
            jp = jsw.build(jcfg, jsw.make_mesh(jax.devices()[:d]))
            tp = tsw.plan_mesh(tcfg, d)
            assert (tp.tier == "planar") == jp.planar, (n_chan, d)
            assert tp.factors == jp.planar_factors, (n_chan, d)
    assert tsw.plan_mesh(twb.WidebandConfig(
        **_kw(2560, chunk_in=2560 * 128), **twb.PROFILES["fast"]),
        8).factors == (20, 128, 24)
    # chan_factors (5, 512) on one shard: the port runs the serial program
    kw = _kw(2560, chunk_in=2560 * 128, chan_factors=(5, 512))
    tcfg = twb.WidebandConfig(**kw, **twb.PROFILES["fast"])
    jcfg = jwb.WidebandConfig(**kw, **jwb.PROFILES["fast"])
    assert tsw.plan_mesh(tcfg, 1).factors == (5, 512, 5)
    assert jsw.build(jcfg, jsw.make_mesh(jax.devices()[:1])
                     ).planar_factors == (10, 256, 10)
    iq = _chunks(2560 * 128, seed=3)
    _, proc, (_, a_m, _), (_, a_s) = _serial_and_mesh(
        2560, 1, "fast", list(iq[:1]), chunk_in=2560 * 128,
        chan_factors=(5, 512))
    np.testing.assert_array_equal(a_m[0].numpy(), a_s[0].numpy())
    # the quality tier at 2560 channels, 8 shards: the reference prefers
    # n2 = 512 (its split stage B), the port the serial n2 = 256, and both
    # come to the least padding, (20, 128, 24)
    kw = _kw(2560, chunk_in=2560 * 128)
    jq = jsw.build(jwb.WidebandConfig(**kw, **jwb.PROFILES["quality"]),
                   jsw.make_mesh(jax.devices()[:2]))
    tq = tsw.plan_mesh(twb.WidebandConfig(**kw, **twb.PROFILES["quality"]),
                       2)
    assert jq.planar_factors == tq.factors == (10, 256, 10)


def test_short_passband_goes_to_the_time_major_tier():
    """33 taps leave no in-tail FIR block. The reference's mesh planar
    predicate does not check for one and its step raises; the port follows
    the serial predicate and runs the time-major tier, equal to its serial
    path (which is time-major too at this config)."""
    kw = _kw(512, n_taps=33)
    jcfg = jwb.WidebandConfig(**kw, **jwb.PROFILES["quality"])
    jproc = jsw.build(jcfg, jsw.make_mesh(jax.devices()[:2]))
    assert jproc.planar
    iq = _chunks(512 * NF, seed=2)
    with pytest.raises(ValueError, match="W_tailpass"):
        jproc(jwb.make_params(jcfg), jwb.init_state(jcfg), iq[0])
    cfg, proc, (_, a_m, _), (_, a_s) = _serial_and_mesh(
        512, 2, "quality", list(iq), n_taps=33)
    assert proc.tier == "tmajor" and not twb._planar_active(cfg)
    for a, b in zip(a_m, a_s):
        assert _snr(b.numpy(), a.numpy()) >= 80.0


# -------------------------------------------------------------------------
# the channelizer kernel's mesh form: a shard axis and phantom planes

def _jax_shard(cfg, factors, n1_pad, head, x):
    """The reference's channelizer on one shard with its head."""
    fast = cfg.chan_precision == "default"
    _, (rr, ri) = jcf.channelize_fused_c(
        jwb.pfb_plan(cfg), jnp.asarray(jch.taps_matrix(
            *jch.design(cfg.n_chan, cfg.taps_per))),
        jcx.CX(jnp.asarray(head[0]), jnp.asarray(head[1])),
        jcx.CX(jnp.asarray(x[0]), jnp.asarray(x[1])), bf16_mxu=fast,
        tile_t=64, interpret=True, out_layout="raw3",
        out_dtype=jnp.bfloat16 if fast else jnp.float32, factors=factors,
        n1_pad=n1_pad)
    return np.asarray(rr, np.float32), np.asarray(ri, np.float32)


@pytest.mark.parametrize("prof,tol", [("fast", 70.0), ("quality", 95.0)])
def test_channelizer_shards_and_phantom_planes_match_reference(prof, tol):
    """The plain version with D = 2 shards and n1_out = 4 at (3, 128)
    against the reference's `channelize_fused_c(n1_pad=4)` shard by shard
    (TOL as tests/test_torch_channelizer.py: bf16 planes ≥ 70 dB, float32
    ≥ 95 dB); the phantom plane is exact zeros on both sides."""
    M, D, nf = 384, 2, 64
    cfg = twb.WidebandConfig(**_kw(M), **twb.PROFILES[prof])
    plan = twb.pfb_plan(cfg)
    W = tch.taps_matrix(plan, tch.design(M, cfg.taps_per)[1])
    rng = np.random.default_rng(4)
    head = rng.normal(size=(2, D, plan.history)).astype(np.float32) * 0.05
    x = rng.normal(size=(2, D, nf * M)).astype(np.float32) * 0.05
    fast = prof == "fast"
    tails, (rr, ri) = tcf.channelize_fused_c(
        plan, W, tcx.CX(*(torch.from_numpy(h) for h in head)),
        tcx.CX(*(torch.from_numpy(v) for v in x)), factors=(3, 128),
        bf16_mxu=fast, out_dtype=torch.bfloat16 if fast else torch.float32,
        n1_pad=4)
    assert rr.shape == (D, 4, nf, 128)
    assert not rr[:, 3].float().any() and not ri[:, 3].float().any()
    np.testing.assert_array_equal(tails.re.numpy(),
                                  x[0][:, -plan.history:])
    for s in range(D):
        jr, ji = _jax_shard(cfg, (3, 128), 4, head[:, s], x[:, s])
        assert not jr[3].any() and not ji[3].any()
        for j, t in ((jr, rr[s]), (ji, ri[s])):
            assert _snr(j[:3], t[:3].float().numpy()) >= tol


@pytest.mark.parametrize("layout", ["raw3", "time"])
def test_one_shard_is_the_plain_form_bit_for_bit(layout):
    """D = 1 with n1_out = n1 is the unsharded channelizer, bit for bit,
    on float32 and int16 input."""
    M = 512
    cfg = twb.WidebandConfig(**_kw(M), **twb.PROFILES["fast"])
    plan = twb.pfb_plan(cfg)
    W = tch.taps_matrix(plan, tch.design(M, cfg.taps_per)[1])
    rng = np.random.default_rng(8)
    carry = tcx.CX(*(torch.from_numpy(rng.normal(size=plan.history)
                                      .astype(np.float32)) for _ in range(2)))
    for x in (tcx.CX(*(torch.from_numpy(rng.normal(size=M * 64)
                                        .astype(np.float32))
                       for _ in range(2))),
              tuple(torch.from_numpy((rng.normal(size=M * 64) * 1000)
                                     .astype(np.int16)) for _ in range(2))):
        kw = dict(factors=(2, 256), bf16_mxu=True, out_layout=layout,
                  out_dtype=torch.bfloat16 if layout == "raw3"
                  else torch.float32)
        c1, flat = tcf.channelize_fused_c(plan, W, carry, x, **kw)
        xs = tcx.CX(x.re[None], x.im[None]) if isinstance(x, tcx.CX) \
            else tuple(v[None] for v in x)
        cD, shard = tcf.channelize_fused_c(
            plan, W, tcx.CX(carry.re[None], carry.im[None]), xs,
            n1_pad=2 if layout == "raw3" else None, **kw)
        for a, b in zip(flat, shard):
            np.testing.assert_array_equal(a.float().numpy(),
                                          b[0].float().numpy())
        np.testing.assert_array_equal(c1.re.numpy(), cD.re[0].numpy())
    with pytest.raises(ValueError, match="n1_pad"):
        tcf.channelize_fused_c(plan, W, carry, x, factors=(2, 256),
                               bf16_mxu=True, out_layout="time", n1_pad=4)
    with pytest.raises(ValueError, match="n1_pad"):
        tcf.channelize_fused_c(plan, W, carry, x, factors=(2, 256),
                               bf16_mxu=True, n1_pad=1)


def test_build_and_process_refuse_what_they_cannot_run():
    cfg = twb.WidebandConfig(**_kw(512, chunk_in=512 * 64),
                             **twb.PROFILES["fast"])
    jcfg = jwb.WidebandConfig(**_kw(512, chunk_in=512 * 64),
                              **jwb.PROFILES["fast"])
    for d in (3, 1024):            # not a divisor of n_chan / chunk_in
        with pytest.raises(ValueError, match="divide"):
            tsw.build(cfg, tsw.make_mesh(d, device="cpu"))
    with pytest.raises(ValueError, match="divide"):
        jsw.build(jcfg, jsw.make_mesh(jax.devices()[:3]))
    # a shard shorter than the PFB history (7 · 8 samples)
    short = twb.WidebandConfig(fs_in=96_000, n_chan=8, chunk_in=256,
                               taps_per=8, n_taps=129)
    with pytest.raises(ValueError, match="history"):
        tsw.build(short, tsw.make_mesh(8, device="cpu"))
    proc = tsw.build(cfg, tsw.make_mesh(2, device="cpu"))
    p = twb.make_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="chunk must be"):
        proc(p, twb.init_state(cfg, device="cpu"),
             np.zeros(512 * 32, np.complex64))
    with pytest.raises(ValueError, match="n_shards"):
        tsw.make_mesh(0, device="cpu")
    assert tsw.make_mesh(device="cpu").n_shards == 1
