"""The port's chain tails (the plain PyTorch versions of both tail
kernels) against the JAX package's `chain_tail_am(…, interpret=True)`:
the FIR-fused tail on the channelizer's raw planar planes, and the
non-FIR tail on passband planes, two chained calls each.

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
             real, rs_dot3, rb, hang_window=0):
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
        accum_pow=True, fir=fir, hang_window=hang_window)
    st2 = np.asarray(st2).transpose(1, 0, 2).reshape(4 + PER, C)
    return np.asarray(audio), st2


CASES = [("AM", "fast", "high"), ("AM", "quality", "high"),
         ("AM", "fast", "default"), ("USB", "quality", "high"),
         ("USB", "fast", "high"), ("NBFM", "quality", "high")]


@pytest.mark.parametrize("mode,tier,rs_prec", CASES)
def test_tail_matches_reference_two_calls(mode, tier, rs_prec):
    cfg = _chain_cfg(mode, tier, rs_prec)
    agc_kw = dict(on=False) if mode == "NBFM" else None
    tp = tchain.make_params(cfg, agc_kwargs=agc_kw, device="cpu")
    tile = tchain._tail_tile(NF, N_TAPS)
    B, n_prev = tfm.tail_fir_block(NF, N_TAPS, tile)
    rb = 32 if tile % 32 == 0 else (16 if tile % 16 == 0 else 0)
    w2 = tp.W_tailpass.numpy()
    real = w2.shape[1] == B
    assert real == (mode != "USB")
    P = tp.P_interp.numpy()
    PER = P.shape[0]
    par = tchain._tail_params_vec(tp, cfg)
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
        a_j, st_j = _run_jax(x, head, st_j, par.numpy(), w2, P, tile=tile,
                             B=B, n_prev=n_prev, demod=demod, fast=fast,
                             real=real, rs_dot3=not rs_bf16, rb=rb)
        tx = [torch.from_numpy(v) for v in x]
        if fast:
            tx = [v.to(torch.bfloat16) for v in tx]
        a_t, st_t = tct.chain_tail_fir(
            *tx, *(torch.from_numpy(np.ascontiguousarray(h)) for h in head),
            st_t, par, tp.W_tailpass, tp.P_interp, n_taps=N_TAPS, B=B,
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
    tv = tchain._tail_params_vec(tchain.make_params(tcfg, device="cpu"),
                                 tcfg).numpy()
    assert tv.shape == jv.shape == (tct.N_PARAMS,)
    np.testing.assert_array_equal(jv, tv)


def test_tail_wrapper_rejects_bad_inputs():
    cfg = _chain_cfg("AM", "quality", "high")
    tp = tchain.make_params(cfg, device="cpu")
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


def _bursty_planes(mode, rng, nf, C):
    """Passband planes [nf, C]: FM carriers for NBFM, else AM carriers
    gated on and off within the chunk (so the hang holds and releases)."""
    t = np.arange(nf)[:, None] / FS
    ph0 = rng.uniform(0, 2 * np.pi, size=C)
    if mode == "NBFM":
        g = rng.uniform(300.0, 1000.0, size=C)
        beta = rng.uniform(1.0, 2.5, size=C)
        z = 0.4 * np.exp(1j * (beta * np.sin(2 * np.pi * g * t) + ph0))
    else:
        gate = (np.sin(2 * np.pi * rng.uniform(20, 60, size=C) * t) > 0)
        z = 0.3 * (0.05 + gate) * (1 + 0.5 * np.sin(2 * np.pi * 700 * t)) \
            * np.exp(1j * ph0)
    z = z + 0.003 * (rng.normal(size=(nf, C)) + 1j * rng.normal(size=(nf, C)))
    return (np.ascontiguousarray(z.real, np.float32),
            np.ascontiguousarray(z.imag, np.float32))


# (mode, accum_pow, hang ring tiles) — the window W gives
# ceil((W − 1)/T) ring tiles at T = 128
AM_CASES = [("AM", False, 0), ("AM", True, 1), ("AM", True, 7),
            ("USB", True, 0), ("USB", False, 7), ("NBFM", True, 1),
            ("NBFM", False, 0)]
T_AM = 128


@pytest.mark.parametrize("mode,accum,tiles", AM_CASES)
def test_tail_am_matches_reference_two_calls(mode, accum, tiles):
    """The non-FIR tail's plain version against `chain_tail_am` without
    `fir` (the reference's `_kernel`), with the hang flag on: y handed
    over as the real/imag views of a chain-major complex [C, nf] tensor,
    audio asked for chain-major, as `chain._process_tail_pallas` does."""
    C_ = 256
    W = {0: 0, 1: 100, 7: 6 * T_AM + 50}[tiles]
    assert tct.hang_tiles_for(W, T_AM) == tiles
    cfg = tchain.ChainConfig(mode=mode, iq_rate=FS, chunk=NF, os_block=NF,
                             n_taps=N_TAPS)
    tp = tchain.make_params(cfg, agc_kwargs=dict(on=mode != "NBFM",
                                                 hang=True), device="cpu")
    par = tchain._tail_params_vec(tp, cfg)
    assert float(par[8]) == 1.0
    P = tp.P_interp
    PER, L = P.shape
    rows_j = 4 + PER - 1 + int(accum)
    st_j = np.zeros((rows_j, C_), np.float32)
    st_j[2] = -120.0
    st_t = torch.zeros(4 + PER, C_)
    st_t[2] = -120.0
    demod = tchain._tail_demod(cfg)
    rng = np.random.default_rng(8)
    for call in range(2):
        yr, yi = _bursty_planes(mode, rng, NF, C_)
        a_j, st2 = jct.chain_tail_am(
            jnp.asarray(yr), jnp.asarray(yi),
            jnp.asarray(st_j.reshape(rows_j, C_ // 128, 128)
                        .transpose(1, 0, 2)),
            jnp.asarray(par.numpy()), P.numpy(), tile_t=T_AM, L=L,
            demod=demod, interpret=True, accum_pow=accum, hang_window=W)
        st_j = np.asarray(st2).transpose(1, 0, 2).reshape(rows_j, C_)
        y = torch.complex(torch.from_numpy(yr.T.copy()),
                          torch.from_numpy(yi.T.copy()))      # [C, nf]
        a_t, st_t = tct.chain_tail_am(
            y.real.T, y.imag.T, st_t, par, P, tile_t=T_AM, demod=demod,
            accum_pow=accum, hang_window=W, audio_layout="chan")
        assert a_t.shape == (C_, NF * L)
        skip = 1280 if (mode == "NBFM" and call == 0) else 0
        snr_a = _snr(np.asarray(a_j).T[:, skip:], a_t.numpy()[:, skip:])
        snr_s = _snr(st_j[:4 + PER - 1], st_t.numpy()[:4 + PER - 1])
        assert snr_a >= TOL_DB and snr_s >= TOL_DB, (call, snr_a, snr_s)
        if accum:
            np.testing.assert_allclose(st_t.numpy()[-1], st_j[-1],
                                       rtol=1e-4)
            st_j = st_j.copy()
            st_j[-1] = 0.0
        else:
            assert not st_t[-1].any()
        st_t = st_t.clone()
        st_t[-1] = 0.0


def test_tail_am_layouts_agree():
    """Time-major and chain-major sources and outputs give the same
    numbers (the kernel reads and writes both by element strides)."""
    cfg = tchain.ChainConfig(mode="AM", iq_rate=FS, chunk=NF, os_block=NF,
                             n_taps=N_TAPS)
    tp = tchain.make_params(cfg, device="cpu")
    par = tchain._tail_params_vec(tp, cfg)
    yr, yi = _bursty_planes("AM", np.random.default_rng(2), NF, 24)
    st = torch.zeros(4 + tp.P_interp.shape[0], 24)
    kw = dict(tile_t=T_AM, demod="am", accum_pow=True, hang_window=300)
    a_time, s_time = tct.chain_tail_am(torch.from_numpy(yr),
                                       torch.from_numpy(yi), st, par,
                                       tp.P_interp, **kw)
    y = torch.complex(torch.from_numpy(yr.T.copy()),
                      torch.from_numpy(yi.T.copy()))
    a_chan, s_chan = tct.chain_tail_am(y.real.T, y.imag.T, st, par,
                                       tp.P_interp, audio_layout="chan",
                                       **kw)
    assert torch.equal(a_time.T, a_chan)
    # the power row sums the same squares in another memory order
    torch.testing.assert_close(s_chan, s_time, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("hang_on", [True, False])
def test_fir_tail_hang_matches_reference(hang_on):
    """The FIR tail with a hang window. Hang on: against the reference
    with its hang window and `agc.hang` on. Hang flag off: against the
    reference without a hang window (`hang_enabled=False`) — the
    reference's FIR kernel reads the flag from past its 8-slot parameter
    block and does not honour it (ROADMAP queue 3); the port's does."""
    cfg = _chain_cfg("AM", "quality", "high")
    tp = tchain.make_params(cfg, agc_kwargs=dict(hang=hang_on), device="cpu")
    tile = tchain._tail_tile(NF, N_TAPS)
    B, n_prev = tfm.tail_fir_block(NF, N_TAPS, tile)
    rb = 32 if tile % 32 == 0 else (16 if tile % 16 == 0 else 0)
    w2 = tp.W_tailpass.numpy()
    P = tp.P_interp.numpy()
    PER = P.shape[0]
    par = tchain._tail_params_vec(tp, cfg)
    W = 2 * tile + 40                              # 3 ring tiles
    rng = np.random.default_rng(12)
    ov = N_TAPS - 1
    head = [np.zeros((ov, C), np.float32)] * 2
    st_j = np.zeros((4 + PER, C), np.float32)
    st_j[2] = -120.0
    st_t = torch.from_numpy(st_j.copy())
    for call in range(2):
        yr, yi = _bursty_planes("AM", rng, NF, C)
        x = [v.reshape(NF, N1, N2).transpose(1, 0, 2).copy()
             for v in (yr, yi)]
        a_j, st_j = _run_jax(x, head, st_j, par.numpy(), w2, P, tile=tile,
                             B=B, n_prev=n_prev, demod="am", fast=False,
                             real=True, rs_dot3=True, rb=rb,
                             hang_window=W if hang_on else 0)
        a_t, st_t = tct.chain_tail_fir(
            *(torch.from_numpy(v) for v in x),
            *(torch.from_numpy(np.ascontiguousarray(h)) for h in head),
            st_t, par, tp.W_tailpass, tp.P_interp, n_taps=N_TAPS, B=B,
            n_prev=n_prev, tile_t=tile, demod="am", fir_bf16=False,
            rs_bf16=False, hang_window=W)
        snr_a = _snr(a_j, a_t.numpy())
        snr_s = _snr(st_j[:4 + PER - 1], st_t.numpy()[:4 + PER - 1])
        assert snr_a >= TOL_DB and snr_s >= TOL_DB, (call, snr_a, snr_s)
        head = [v.transpose(1, 0, 2).reshape(NF, C)[-ov:] for v in x]
        st_j = st_j.copy()
        st_j[-1] = 0.0


def test_tail_am_wrapper_rejects_bad_inputs():
    cfg = tchain.ChainConfig(mode="AM", iq_rate=FS, chunk=NF, os_block=NF,
                             n_taps=N_TAPS)
    tp = tchain.make_params(cfg, device="cpu")
    par = tchain._tail_params_vec(tp, cfg)
    y = torch.zeros(NF, 16)
    st = torch.zeros(4 + tp.P_interp.shape[0], 16)
    with pytest.raises(ValueError):                  # 8-slot vector
        tct.chain_tail_am(y, y, st, par[:8], tp.P_interp, tile_t=T_AM,
                          demod="am")
    with pytest.raises(ValueError):                  # tile not dividing nf
        tct.chain_tail_am(y, y, st, par, tp.P_interp, tile_t=96,
                          demod="am")
    with pytest.raises(ValueError):
        tct.chain_tail_am(y, y.double(), st, par, tp.P_interp, tile_t=T_AM,
                          demod="am")
