"""The port's time-major wideband tier off the planar coupling against the
JAX package's, on the CPU.

A 512-channel config whose chunk of 264 frames `chan_tile_t` (128 on
fast, 64 on quality) does not divide: both packages' predicates put it on
the time-major fused tier (`_tmajor_fused_ok` and not `_planar_active`;
asserted, so a shape that slips to another tier fails). The reference runs
`wideband.process` with its Pallas kernels in interpret mode (the fused
channelizer's `out_layout="time"`, the FIR tail on the 2-D source); the
port runs its plain versions. With a 33-tap passband no in-tail FIR block
exists, and both run the standalone time-major Toeplitz passband and the
non-FIR tail. Rows are in bin order on this tier in both packages.

Tolerances: audio SNR ≥ 45 dB on fast (the bf16 comparison class of
tests/test_wideband.py) and ≥ 80 dB on quality (float32 on both sides;
the reference's split-bf16 ×3 dots, the DC pole and the AGC's exp set the
floor); RSSI within 0.01 dB, 0.05 dB on fast (bf16 stage B and FIR
operands)."""

import jax
import numpy as np
import pytest
import torch

from supersdr_tpu.runtime import wideband as jwb
from supersdr_tpu_torch import convert
from supersdr_tpu_torch.runtime import wideband as twb

BASE = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 264,
            taps_per=4, n_taps=129, mode="AM")
# no in-tail FIR block for 32 taps of history: the standalone passband
SHORT = dict(BASE, chunk_in=512 * 256, n_taps=33)
SNR_MIN = {"fast": 45.0, "quality": 80.0}
RSSI_TOL = {"fast": 0.05, "quality": 0.01}


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _chunks(base, kind, seed=11):
    n = base["chunk_in"]
    rng = np.random.default_rng(seed)
    if kind == "i16":
        return [tuple((rng.normal(size=n) * 0.05 * 32768).astype(np.int16)
                      for _ in range(2)) for _ in range(2)]
    return list(((rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n)))
                 * 0.05).astype(np.complex64))


def _both(base, tier):
    jcfg = jwb.WidebandConfig(**base, **jwb.PROFILES[tier])
    tcfg = twb.WidebandConfig(**base, **twb.PROFILES[tier])
    for mod, cfg in ((jwb, jcfg), (twb, tcfg)):
        assert mod._tmajor_fused_ok(cfg) and not mod._planar_active(cfg)
        np.testing.assert_array_equal(mod.audio_channel_order(cfg),
                                      np.arange(cfg.n_chan))
    return jcfg, tcfg


def _run_ref(jcfg, chunks):
    p = jwb.make_params(jcfg)
    st = jwb.init_state(jcfg)
    outs = []
    for iq in chunks:
        run = jwb.process_i16 if isinstance(iq, tuple) else jwb.process
        st, out = run(jcfg, p, st, iq)
        outs.append(out)
    return p, st, outs


def _run_port(tcfg, chunks, state=None):
    p = twb.make_params(tcfg, device="cpu")
    st = twb.init_state(tcfg, device="cpu") if state is None else state
    outs = []
    for iq in chunks:
        st, out = twb.process(tcfg, p, st, iq)
        outs.append(out)
    return p, st, outs


@pytest.mark.parametrize("kind", ["f32", "i16"])
@pytest.mark.parametrize("tier", ["fast", "quality"])
def test_tmajor_tier_matches_reference(tier, kind):
    jcfg, tcfg = _both(BASE, tier)
    chunks = _chunks(BASE, kind)
    jp, jst, ref = _run_ref(jcfg, chunks)
    tp, tst, got = _run_port(tcfg, chunks)
    assert jp.chain.W_tailpass is not None
    assert tp.chain.W_tailpass is not None
    for k in range(2):
        assert got[k].audio.shape == ref[k].audio.shape == (264 * 4, 512)
        assert got[k].baseband is None and ref[k].baseband is None
        snr = _snr(ref[k].audio, got[k].audio.numpy())
        assert snr >= SNR_MIN[tier], (tier, kind, k, snr)
        np.testing.assert_allclose(got[k].rssi.numpy(),
                                   np.asarray(ref[k].rssi),
                                   atol=RSSI_TOL[tier])
    # the carried state is the reference's, in bin order
    ref_leaves = jax.tree_util.tree_leaves(jst)
    got_leaves = jax.tree_util.tree_leaves(convert.to_numpy(tst))
    assert len(ref_leaves) == len(got_leaves)
    np.testing.assert_allclose(convert.to_numpy(tst).chain.os_carry.re,
                               np.asarray(jst.chain.os_carry.re),
                               rtol=0, atol=2e-2 if tier == "fast" else 1e-5)


@pytest.mark.parametrize("tier", ["fast", "quality"])
def test_standalone_passband_branch_matches_reference(tier):
    """No in-tail FIR block: the time-major Toeplitz passband, then the
    non-FIR tail on yT with its power row; the baseband comes back."""
    jcfg, tcfg = _both(SHORT, tier)
    chunks = _chunks(SHORT, "f32", seed=12)
    jp, _, ref = _run_ref(jcfg, chunks)
    tp, _, got = _run_port(tcfg, chunks)
    assert jp.chain.W_tailpass is None and tp.chain.W_tailpass is None
    for k in range(2):
        snr = _snr(ref[k].audio, got[k].audio.numpy())
        assert snr >= SNR_MIN[tier], (tier, k, snr)
        np.testing.assert_allclose(got[k].rssi.numpy(),
                                   np.asarray(ref[k].rssi),
                                   atol=RSSI_TOL[tier])
        assert got[k].baseband.re.shape == (256, 512)
        bb = _snr(np.asarray(ref[k].baseband.re), got[k].baseband.re.numpy())
        assert bb >= SNR_MIN[tier], (tier, k, bb)


@pytest.mark.parametrize("base", [BASE, SHORT], ids=["fir-tail", "am-tail"])
def test_state_moves_between_tiers_mid_stream(base):
    """The state is the same on every tier (the reference's claim for its
    time-major body): a stream that changes tier between chunks equals
    one that stays, in either direction."""
    _, tcfg = _both(base, "quality")
    ccfg = twb.WidebandConfig(**base, **dict(twb.PROFILES["quality"],
                                             time_major=False))
    chunks = _chunks(base, "f32", seed=13)
    _, st_t, out_t = _run_port(tcfg, chunks)
    _, st_c, out_c = _run_port(ccfg, chunks)
    _, st_t1, _ = _run_port(tcfg, chunks[:1])
    _, st_c1, _ = _run_port(ccfg, chunks[:1])
    _, _, mixed_tc = _run_port(ccfg, chunks[1:], state=st_t1)
    _, _, mixed_ct = _run_port(tcfg, chunks[1:], state=st_c1)
    assert _snr(out_c[1].audio.numpy(), mixed_tc[0].audio.numpy()) >= 80.0
    assert _snr(out_t[1].audio.numpy(), mixed_ct[0].audio.numpy()) >= 80.0
    assert _snr(out_c[1].audio.numpy().T, out_t[1].audio.numpy()) >= 80.0
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_numpy(st_t)),
                    jax.tree_util.tree_leaves(convert.to_numpy(st_c))):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_channelizer_time_layout_is_the_bin_ordered_transpose():
    """out_layout="time" against the chan-major dispatch of the same
    kernel (its raw planes permuted to bin order)."""
    from supersdr_tpu_torch.ops.cuda import channelize_fused as cf
    tcfg = twb.WidebandConfig(**BASE, **twb.PROFILES["quality"])
    p = twb.make_params(tcfg, device="cpu")
    st = twb.init_state(tcfg, device="cpu")
    iq = twb.coerce(_chunks(BASE, "f32")[0], torch.device("cpu"))
    _, (tr, ti) = cf.channelize_fused_c(
        twb.pfb_plan(tcfg), p.W_pfb, st.pfb_carry, iq, factors=(2, 256),
        bf16_mxu=False, out_layout="time")
    ccfg = twb.WidebandConfig(**BASE, **dict(twb.PROFILES["quality"],
                                             time_major=False))
    _, chans = twb.channelize_dispatch(ccfg, p, st.pfb_carry, iq)
    assert tr.shape == (264, 512) and tr.dtype == torch.float32
    assert torch.equal(torch.complex(tr, ti), chans.T)
    with pytest.raises(ValueError, match="float32"):
        cf.channelize_fused_c(twb.pfb_plan(tcfg), p.W_pfb, st.pfb_carry, iq,
                              factors=(2, 256), bf16_mxu=False,
                              out_dtype=torch.bfloat16, out_layout="time")


def test_time_major_fir_matches_chan_major_fir():
    """`fir_matmul_stream_tmajor_c` is `fir_matmul_stream_c` transposed:
    the same W, the same carry held time-major."""
    from supersdr_tpu_torch.ops import cx, fir_matmul
    rng = np.random.default_rng(3)
    plan = fir_matmul.plan_for(512, 33)
    taps = rng.normal(size=33) + 1j * rng.normal(size=33)
    W = fir_matmul.build_w(plan, taps)
    x = cx.CX(*(torch.from_numpy(rng.normal(size=(6, 512)).astype(
        np.float32)) for _ in range(2)))
    c = cx.CX(*(torch.from_numpy(rng.normal(size=(6, 32)).astype(
        np.float32)) for _ in range(2)))
    c1, y1 = fir_matmul.fir_matmul_stream_c(plan, W, c, x)
    c2, y2 = fir_matmul.fir_matmul_stream_tmajor_c(
        plan, W, cx.CX(c.re.T, c.im.T), cx.CX(x.re.T.contiguous(),
                                             x.im.T.contiguous()))
    np.testing.assert_allclose(y2.re.T.numpy(), y1.re.numpy(), atol=1e-5)
    np.testing.assert_allclose(y2.im.T.numpy(), y1.im.numpy(), atol=1e-5)
    assert torch.equal(c2.re.T, c1.re) and torch.equal(c2.im.T, c1.im)
    with pytest.raises(ValueError, match="chunk % block"):
        fir_matmul.fir_matmul_stream_tmajor_c(
            plan, W, cx.CX(c.re.T, c.im.T),
            cx.CX(x.re.T[:500].contiguous(), x.im.T[:500].contiguous()))
