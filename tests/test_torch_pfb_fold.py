"""The port's polyphase fold (the plain version of `csrc/pfb_fold.cu`) and
its chan-major channelizers against the JAX package's, on the CPU.

The JAX fold runs `pfb_fold_c(interpret=True)`, its Pallas kernel in
interpret mode, as the JAX suite runs it. Tolerances: the fold is eight
float32 products summed in the same order on both sides, so it must agree
to float32 rounding (≥ 130 dB); the channelizers add an M-point DFT — the
port's `torch.fft` against the reference's `jnp.fft` or its two-stage DIF
matrix products — float32 sums in other orders: ≥ 110 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.ops import channelizer as jch
from supersdr_tpu.ops.pallas import pfb_fold as jpf
from supersdr_tpu_torch.ops import channelizer as tch
from supersdr_tpu_torch.ops import cx as tcx
from supersdr_tpu_torch.ops.cuda import pfb_fold as tpf

FOLD_DB = 130.0
CHAN_DB = 110.0


def _snr(ref, got):
    ref = np.asarray(ref, np.complex128)
    got = np.asarray(got, np.complex128)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _inputs(M, K, nf, seed):
    rng = np.random.default_rng(seed)
    h = (K - 1) * M
    carry = ((rng.normal(size=h) + 1j * rng.normal(size=h)) * 0.05
             ).astype(np.complex64)
    x = ((rng.normal(size=nf * M) + 1j * rng.normal(size=nf * M)) * 0.05
         ).astype(np.complex64)
    return carry, x


def _cx(z):
    return tcx.as_cx(z)


# frame counts that the reference's 256-frame tile does not divide (300,
# 520) and ones shorter than a tile (13, 1)
@pytest.mark.parametrize("M,K,nf", [(128, 8, 300), (256, 8, 13),
                                    (256, 4, 520), (128, 3, 1)])
def test_fold_plain_matches_pallas_interpret(M, K, nf):
    plan, proto = jch.design(M, K)
    G = np.asarray(jpf.fold_taps(plan, proto))
    carry, x = _inputs(M, K, nf, seed=M + nf)
    ref = np.asarray(jpf.pfb_fold_c(plan, jnp.asarray(G), jnp.asarray(carry),
                                    jnp.asarray(x), interpret=True))
    tplan, tproto = tch.design(M, K)
    Gt = tpf.fold_taps(tplan, tproto)
    np.testing.assert_array_equal(Gt.numpy(), G)
    got = tpf.pfb_fold(tplan, Gt, _cx(carry), _cx(x))
    assert got.dtype == torch.complex64 and got.shape == (nf, M)
    assert _snr(ref, got.numpy()) >= FOLD_DB


@pytest.mark.parametrize("M,K,nf", [(256, 8, 40), (128, 4, 13)])
def test_channelize_pallas_matches_reference(M, K, nf):
    plan, proto = jch.design(M, K)
    G = jpf.fold_taps(plan, proto)
    carry, x = _inputs(M, K, nf, seed=3)
    jc, jout = jpf.channelize_pallas(plan, G, carry, x, interpret=True)
    tplan, tproto = tch.design(M, K)
    tc, tout = tpf.channelize_pallas_c(tplan, tpf.fold_taps(tplan, tproto),
                                       _cx(carry), _cx(x))
    assert tout.shape == (M, nf)
    assert _snr(np.asarray(jout), tout.numpy()) >= CHAN_DB
    np.testing.assert_array_equal(tc.re.numpy(), np.asarray(jc.re))
    np.testing.assert_array_equal(tc.im.numpy(), np.asarray(jc.im))


@pytest.mark.parametrize("impl,M,K,nf,osr", [
    ("legacy", 256, 8, 40, 1), ("legacy", 100, 8, 24, 1),
    ("legacy", 64, 4, 32, 2), ("mxu2", 16, 4, 64, 1),
    ("mxu2", 2560, 8, 8, 1), ("mxu2", 512, 4, 24, 1)])
def test_channelizers_match_reference(impl, M, K, nf, osr):
    """`channelize_c` (critical and 2× oversampled) and `channelize_mxu2_c`
    (the reference's DIF matrix products, or its direct DFT for M ≤ 256)
    against the port's fold + `torch.fft`, over two chained calls."""
    plan, proto = jch.design(M, K, osr=osr)
    W = jch.taps_matrix(plan, proto)
    tplan, tproto = tch.design(M, K, osr=osr)
    Wt = tch.taps_matrix(tplan, tproto)
    rng = np.random.default_rng(M + nf)
    jc = jnp.zeros(plan.history, jnp.complex64)
    tc = torch.zeros(tplan.history, dtype=torch.complex64)
    for _ in range(2):
        x = ((rng.normal(size=nf * M) + 1j * rng.normal(size=nf * M))
             * 0.05).astype(np.complex64)
        if impl == "legacy":
            jc, jout = jax.jit(jch.channelize_c, static_argnums=0)(
                plan, W, jc, jnp.asarray(x))
            tc, tout = tch.channelize_c(tplan, Wt, tc, torch.from_numpy(x))
        else:
            jc, jout = jax.jit(jch.channelize_mxu2_c, static_argnums=0)(
                plan, W, jc, jnp.asarray(x))
            tc, tout = tch.channelize_mxu2_c(tplan, Wt, tc,
                                             torch.from_numpy(x))
        assert tout.shape == jout.shape
        assert _snr(np.asarray(jout), tout.numpy()) >= CHAN_DB
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tch.mxu2_supported(M) == jch.mxu2_supported(M)


def test_fold_wrapper_rejects_bad_inputs():
    plan, proto = tch.design(128, 8)
    G = tpf.fold_taps(plan, proto)
    carry, x = _inputs(128, 8, 4, seed=1)
    with pytest.raises(ValueError):            # not a multiple of M
        tpf.pfb_fold(plan, G, _cx(carry), _cx(x[:200]))
    with pytest.raises(ValueError):            # wrong carry length
        tpf.pfb_fold(plan, G, _cx(carry[:10]), _cx(x))
    with pytest.raises(ValueError, match="unsupported device"):
        meta = tcx.CX(*(t.to("meta") for t in _cx(x)))
        tpf.pfb_fold(plan, G.to("meta"),
                     tcx.CX(*(t.to("meta") for t in _cx(carry))), meta)
    assert tpf.pfb_fold.launches == 0
