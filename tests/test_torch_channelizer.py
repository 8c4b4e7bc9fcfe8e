"""The port's channelizer (plain PyTorch version of the fused kernel, and
its numpy tables) against the JAX package's.

The JAX side runs `channelize_fused_c(..., interpret=True,
out_layout="raw3")` on the CPU, as the JAX suite does. The port runs
stage B unsplit, so its raw columns are in k2 order; the reference's
quality tier splits stage B and emits columns in `stageb_col_to_k2`
order — the comparison goes through that map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.ops import channelizer as jch
from supersdr_tpu.ops import cx as jcx
from supersdr_tpu.ops.pallas import channelize_fused as jcf
from supersdr_tpu.runtime import wideband as jwb
from supersdr_tpu_torch.ops import channelizer as tch
from supersdr_tpu_torch.ops import cx as tcx
from supersdr_tpu_torch.ops.cuda import channelize_fused as tcf
from supersdr_tpu_torch.runtime import wideband as twb

M, K, NF = 512, 4, 256
BASE = dict(fs_in=M * 12_000, n_chan=M, chunk_in=M * NF, mode="AM",
            taps_per=K, n_taps=129)

# Tolerances (SNR of the port's raw planes against the reference's):
# quality — both ~f32 (the reference's split-bf16 ×3 stage B drops the
# lo·lo term, ~2^-17 relative), so the floor is that term: ≥ 95 dB;
# fast — both round stage B's operands to bf16 and emit bf16 planes, and
# differ only where f32 summation order flips a bf16 rounding: ≥ 70 dB.
TOL_DB = {"fast": 70.0, "quality": 95.0}


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


@pytest.mark.parametrize("M_,n1,n2", [(512, 2, 256), (2560, 10, 256),
                                      (2560, 5, 512), (1024, 4, 256)])
def test_dif_tables_bit_identical(M_, n1, n2):
    for a, b in zip(jch._dif_tables(M_, n1, n2), tch._dif_tables(M_, n1, n2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n2,levels", [(256, 1), (512, 1), (512, 2)])
def test_stageb_split_tables_and_colmap_bit_identical(n2, levels):
    ja, ta = jch._stageb_split_tables(n2, levels), \
        tch._stageb_split_tables(n2, levels)
    np.testing.assert_array_equal(ja[0], ta[0])
    np.testing.assert_array_equal(ja[1], ta[1])
    for (jr, ji), (tr, ti) in zip(ja[2], ta[2]):
        np.testing.assert_array_equal(jr, tr)
        np.testing.assert_array_equal(ji, ti)
    for lev in (0, levels):
        np.testing.assert_array_equal(jch.stageb_col_to_k2(n2, lev),
                                      tch.stageb_col_to_k2(n2, lev))
        assert jch.stageb_split_ok(n2, lev) == tch.stageb_split_ok(n2, lev)


@pytest.mark.parametrize("n_chan,taps_per", [(512, 4), (2560, 8), (16, 8)])
def test_taps_matrix_and_freqs_bit_identical(n_chan, taps_per):
    jplan, jproto = jch.design(n_chan, taps_per)
    tplan, tproto = tch.design(n_chan, taps_per)
    assert (jplan.n_chan, jplan.taps_per, jplan.hop, jplan.history) == \
        (tplan.n_chan, tplan.taps_per, tplan.hop, tplan.history)
    np.testing.assert_array_equal(jproto, tproto)
    np.testing.assert_array_equal(np.asarray(jch.taps_matrix(jplan, jproto)),
                                  tch.taps_matrix(tplan, tproto).numpy())
    fs = n_chan * 12_000
    np.testing.assert_array_equal(jch.channel_center_freqs(jplan, fs),
                                  tch.channel_center_freqs(tplan, fs))
    assert jch._pick_factors(n_chan) == tch._pick_factors(n_chan)


def _jax_raw3(cfg, carry, x, i16):
    n1, n2 = jwb._factors_for(cfg)
    levels = jwb._split_levels_for(cfg, n2)
    fast = cfg.chan_precision == "default"
    xin = (jnp.asarray(x[0]), jnp.asarray(x[1])) if i16 else \
        jcx.CX(jnp.asarray(x[0]), jnp.asarray(x[1]))
    nc, (rr, ri) = jcf.channelize_fused_c(
        jwb.pfb_plan(cfg), jnp.asarray(jch.taps_matrix(
            *jch.design(cfg.n_chan, cfg.taps_per))),
        jcx.CX(jnp.asarray(carry[0]), jnp.asarray(carry[1])), xin,
        bf16_mxu=fast, tile_t=cfg.chan_tile_t, interpret=True,
        out_layout="raw3", out_dtype=jnp.bfloat16 if fast else jnp.float32,
        factors=(n1, n2), split_levels=levels)
    colmap = jch.stageb_col_to_k2(n2, levels)
    return (np.asarray(jnp.real(nc)), np.asarray(jnp.imag(nc))), \
        (np.asarray(rr, np.float32), np.asarray(ri, np.float32)), colmap


@pytest.mark.parametrize("tier", ["fast", "quality"])
@pytest.mark.parametrize("ingest", ["f32", "i16"])
def test_channelize_fused_matches_reference_two_chunks(tier, ingest):
    jcfg = jwb.WidebandConfig(**BASE, **jwb.PROFILES[tier])
    tcfg = twb.WidebandConfig(**BASE, **twb.PROFILES[tier])
    assert twb._factors_for(tcfg) == (2, 256)
    rng = np.random.default_rng(3)
    i16 = ingest == "i16"
    plan = twb.pfb_plan(tcfg)
    W = tch.taps_matrix(plan, tch.design(M, K)[1])
    jc = (np.zeros(plan.history, np.float32),) * 2
    tc = tcx.zeros((plan.history,))
    fast = tier == "fast"
    for _ in range(2):                       # two chunks: carry chaining
        if i16:
            x = tuple((rng.normal(size=M * NF) * 1600).astype(np.int16)
                      for _ in range(2))
            tx = tuple(torch.from_numpy(v) for v in x)
        else:
            x = tuple((rng.normal(size=M * NF) * 0.05).astype(np.float32)
                      for _ in range(2))
            tx = tcx.CX(*(torch.from_numpy(v) for v in x))
        jc, jraw, colmap = _jax_raw3(jcfg, jc, x, i16)
        tc, traw = tcf.channelize_fused_raw3(
            plan, W, tc, tx, factors=(2, 256), bf16_mxu=fast,
            out_dtype=torch.bfloat16 if fast else torch.float32)
        np.testing.assert_array_equal(jc[0], tc.re.numpy())
        np.testing.assert_array_equal(jc[1], tc.im.numpy())
        for j, t in zip(jraw, traw):
            assert t.dtype == (torch.bfloat16 if fast else torch.float32)
            got = t.float().numpy()[:, :, colmap]
            snr = _snr(j, got)
            assert snr >= TOL_DB[tier], (tier, ingest, snr)


def test_new_carry_dequantizes_i16():
    plan = tch.PFBPlan(n_chan=M, taps_per=K, hop=M)
    W = tch.taps_matrix(plan, tch.design(M, K)[1])
    x = tuple(torch.arange(M * 8, dtype=torch.int16) - 7 for _ in range(2))
    carry, _ = tcf.channelize_fused_raw3(
        plan, W, tcx.zeros((plan.history,)), x, factors=(2, 256),
        bf16_mxu=False, out_dtype=torch.float32)
    want = x[0][-plan.history:].float() / 32768.0
    torch.testing.assert_close(carry.re, want, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    plan = tch.PFBPlan(n_chan=M, taps_per=K, hop=M)
    W = tch.taps_matrix(plan, tch.design(M, K)[1])
    carry = tcx.zeros((plan.history,))
    x = tcx.zeros((M * 8,))
    with pytest.raises(ValueError):
        tcf.channelize_fused_raw3(plan, W, carry, x, factors=(4, 128),
                                  bf16_mxu=False, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        tcf.channelize_fused_raw3(plan, W.double(), carry, x,
                                  factors=(2, 256), bf16_mxu=False,
                                  out_dtype=torch.float32)
    with pytest.raises(ValueError):
        tcf.channelize_fused_raw3(plan, W, carry, tcx.zeros((M * 8 + 1,)),
                                  factors=(2, 256), bf16_mxu=False,
                                  out_dtype=torch.float32)
