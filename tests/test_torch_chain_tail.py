"""The port's chain tail (plain PyTorch version of the FIR-fused tail
kernel) against the JAX package's `chain_tail_am(fir=…, interpret=True)`
on the channelizer's raw planar planes, two chained calls.

Both sides get the same numpy inputs. The reference's FIR and resampler
run split-bf16 ×3 (~f32) or 1-pass bf16 dots; the port's plain version
runs f32 products of the same (bf16-rounded, on the fast tier) operands,
and the same in-tile doubling scans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.ops import fir_matmul as jfm
from supersdr_tpu.ops import firdesign, passband
from supersdr_tpu.ops import resample as jrs
from supersdr_tpu.ops.pallas import chain_tail as jct
from supersdr_tpu.runtime import chain as jchain
from supersdr_tpu_torch.ops import fir_matmul as tfm
from supersdr_tpu_torch.ops import resample as trs
from supersdr_tpu_torch.ops.cuda import chain_tail as tct
from supersdr_tpu_torch.runtime import chain as tchain

N1, N2, NF, N_TAPS, FS = 2, 256, 512, 129, 12_000
C = N1 * N2
# Audio and state-row SNR of the port against the reference: both are
# f32 up to the reference's split-bf16 ×3 dots (lo·lo dropped, ~2^-17)
# and the order of f32 sums; the AGC gain (exp of a dB sum) and the DC
# pole (1/(1−0.999) = 1000× gain on a rounding step) amplify that to
# ~1e-5 relative, so ≥ 80 dB. The NBFM angle is compared past the FIR
# and attack transient (1280 audio samples), AGC manual, on FM carriers.
TOL_DB = 80.0


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _chain_cfg(mode, tier, rs_prec):
    return tchain.ChainConfig(
        mode=mode, iq_rate=FS, audio_rate=48_000, chunk=NF, os_block=NF,
        n_taps=N_TAPS, nco_enabled=False, passband_impl="matmul",
        passband_precision="default" if tier == "fast" else "high",
        resample_impl="matmul", resample_precision=rs_prec,
        tail_impl="pallas")


def _planes(mode, rng):
    """Raw [n1, nf, n2] planes: noise, or FM carriers for NBFM."""
    if mode != "NBFM":
        return [(rng.normal(size=(N1, NF, N2)) * 0.05).astype(np.float32)
                for _ in range(2)]
    t = np.arange(NF)[:, None] / FS
    g = rng.uniform(300.0, 1000.0, size=C)
    beta = rng.uniform(1.0, 2.5, size=C)
    ph0 = rng.uniform(0, 2 * np.pi, size=C)
    z = 0.4 * np.exp(1j * (beta * np.sin(2 * np.pi * g * t) + ph0)) \
        + 0.01 * (rng.normal(size=(NF, C)) + 1j * rng.normal(size=(NF, C)))
    z = z.reshape(NF, N1, N2).transpose(1, 0, 2)
    return [np.ascontiguousarray(z.real, np.float32),
            np.ascontiguousarray(z.imag, np.float32)]


def _run_jax(x, head, st, par9, w2, P, *, tile, B, n_prev, demod, fast,
             real, rs_dot3, rb):
    dt = jnp.bfloat16 if fast else jnp.float32
    PH, ov = n_prev * B, N_TAPS - 1
    hz = np.zeros((PH - ov, C), np.float32)
    PER = P.shape[0]
    rows = st.shape[0]
    st_rows = st.reshape(rows, C // 128, 128).transpose(1, 0, 2)
    fir = dict(w2=jnp.asarray(w2),
               head_r=jnp.asarray(np.concatenate([hz, head[0]]), dt),
               head_i=jnp.asarray(np.concatenate([hz, head[1]]), dt),
               x_r=jnp.asarray(x[0], dt), x_i=jnp.asarray(x[1], dt),
               B=B, n_prev=n_prev, dot3=not fast, real=real,
               rs_block=rb, rs_dot3=rs_dot3)
    audio, st2 = jct.chain_tail_am(
        None, None, jnp.asarray(st_rows), jnp.asarray(par9), P,
        tile_t=tile, L=P.shape[1], demod=demod, interpret=True,
        accum_pow=True, fir=fir)
    st2 = np.asarray(st2).transpose(1, 0, 2).reshape(4 + PER, C)
    return np.asarray(audio), st2


CASES = [("AM", "fast", "high"), ("AM", "quality", "high"),
         ("AM", "fast", "default"), ("USB", "quality", "high"),
         ("USB", "fast", "high"), ("NBFM", "quality", "high")]


@pytest.mark.parametrize("mode,tier,rs_prec", CASES)
def test_tail_matches_reference_two_calls(mode, tier, rs_prec):
    cfg = _chain_cfg(mode, tier, rs_prec)
    agc_kw = dict(on=False) if mode == "NBFM" else None
    tp = tchain.make_params(cfg, agc_kwargs=agc_kw)
    tile = tchain._tail_tile(NF, N_TAPS)
    B, n_prev = tfm.tail_fir_block(NF, N_TAPS, tile)
    rb = 32 if tile % 32 == 0 else (16 if tile % 16 == 0 else 0)
    w2 = tp.W_tailpass.numpy()
    real = w2.shape[1] == B
    assert real == (mode != "USB")
    P = tp.P_interp.numpy()
    PER = P.shape[0]
    par8 = tchain._tail_params_vec(tp, cfg)
    par9 = np.concatenate([par8.numpy(), [0.0]]).astype(np.float32)
    demod = tchain._tail_demod(cfg)
    fast = tier == "fast"
    rs_bf16 = rs_prec == "default"
    rng = np.random.default_rng(5)
    ov = N_TAPS - 1
    head = [np.zeros((ov, C), np.float32)] * 2
    st_j = np.zeros((4 + PER, C), np.float32)
    st_j[2] = -120.0
    st_t = torch.from_numpy(st_j.copy())
    for call in range(2):
        x = _planes(mode, rng)
        if fast:                 # the fast tier's raw planes are bf16
            x = [np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
                 for v in x]
        a_j, st_j = _run_jax(x, head, st_j, par9, w2, P, tile=tile, B=B,
                             n_prev=n_prev, demod=demod, fast=fast,
                             real=real, rs_dot3=not rs_bf16, rb=rb)
        tx = [torch.from_numpy(v) for v in x]
        if fast:
            tx = [v.to(torch.bfloat16) for v in tx]
        a_t, st_t = tct.chain_tail_fir(
            *tx, *(torch.from_numpy(np.ascontiguousarray(h)) for h in head),
            st_t, par8, tp.W_tailpass, tp.P_interp, n_taps=N_TAPS, B=B,
            n_prev=n_prev, tile_t=tile, demod=demod, fir_bf16=fast,
            rs_bf16=rs_bf16)
        skip = 1280 if (mode == "NBFM" and call == 0) else 0
        snr_a = _snr(a_j[skip:], a_t.numpy()[skip:])
        snr_s = _snr(st_j[:4 + PER - 1], st_t.numpy()[:4 + PER - 1])
        assert snr_a >= TOL_DB and snr_s >= TOL_DB, (call, snr_a, snr_s)
        np.testing.assert_allclose(st_t.numpy()[-1], st_j[-1], rtol=1e-4)
        # next call's FIR history: the last n_taps−1 input rows, planar
        head = [v.transpose(1, 0, 2).reshape(NF, C)[-ov:] for v in x]
        st_j = st_j.copy()
        st_j[-1] = 0.0           # the power row is per-chunk output only


@pytest.mark.parametrize("chunk,n_taps", [(512, 129), (512, 257),
                                          (16128, 257), (128, 129)])
def test_tail_tables_bit_identical(chunk, n_taps):
    tile = tchain._tail_tile(chunk, n_taps)
    assert tile == jchain._tail_tile(chunk, n_taps)
    bn = tfm.tail_fir_block(chunk, n_taps, tile)
    assert bn == jfm.tail_fir_block(chunk, n_taps, tile)
    for mode in ("AM", "USB", "NBFM", "LSB", "CW"):
        lc, hc = passband.supersdr_passband(mode)
        taps = firdesign.complex_bandpass_taps(lc, hc, FS, n=n_taps)
        assert tfm.taps_are_real(taps) == jfm.taps_are_real(taps)
        if bn is None:
            continue
        np.testing.assert_array_equal(tfm.build_w_free(*bn, taps),
                                      jfm.build_w_free(*bn, taps))
        if tfm.taps_are_real(taps):
            np.testing.assert_array_equal(tfm.build_w_free_real(*bn, taps),
                                          jfm.build_w_free_real(*bn, taps))
    itaps = firdesign.lowpass_taps(FS / 2, 48_000)
    jplan, jP = jrs.plan_interp(4, itaps)
    tplan, tP = trs.plan_interp(4, itaps)
    assert (jplan.L, jplan.n_taps, jplan.per) == \
        (tplan.L, tplan.n_taps, tplan.per)
    np.testing.assert_array_equal(jP, tP)


@pytest.mark.parametrize("mode", ["AM", "NBFM"])
def test_tail_params_vec_matches_reference(mode):
    jcfg = jchain.ChainConfig(mode=mode, iq_rate=FS, chunk=NF, os_block=NF,
                              n_taps=N_TAPS, passband_impl="matmul")
    tcfg = tchain.ChainConfig(mode=mode, iq_rate=FS, chunk=NF, os_block=NF,
                              n_taps=N_TAPS, passband_impl="matmul")
    jv = np.asarray(jchain._tail_params_vec(jchain.make_params(jcfg), jcfg))
    tv = tchain._tail_params_vec(tchain.make_params(tcfg), tcfg).numpy()
    assert tv.shape == (tct.N_PARAMS,)
    np.testing.assert_array_equal(jv[:8], tv)
    assert jv[8] == 0.0          # the reference's hang slot, not ported


def test_tail_wrapper_rejects_bad_inputs():
    cfg = _chain_cfg("AM", "quality", "high")
    tp = tchain.make_params(cfg)
    tile = tchain._tail_tile(NF, N_TAPS)
    B, n_prev = tfm.tail_fir_block(NF, N_TAPS, tile)
    x = torch.zeros(N1, NF, N2)
    head = torch.zeros(N_TAPS - 1, C)
    st = torch.zeros(4 + tp.P_interp.shape[0], C)
    par = tchain._tail_params_vec(tp, cfg)
    kw = dict(n_taps=N_TAPS, B=B, n_prev=n_prev, tile_t=tile, demod="am",
              fir_bf16=False, rs_bf16=False)
    with pytest.raises(ValueError):      # head of the wrong length
        tct.chain_tail_fir(x, x, head[1:], head[1:], st, par,
                           tp.W_tailpass, tp.P_interp, **kw)
    with pytest.raises(ValueError):      # mixed plane dtypes
        tct.chain_tail_fir(x, x.double(), head, head, st, par,
                           tp.W_tailpass, tp.P_interp, **kw)
    with pytest.raises(ValueError):
        tct.chain_tail_fir(x, x, head, head, st, par, tp.W_tailpass,
                           tp.P_interp, **dict(kw, demod="fm"))
