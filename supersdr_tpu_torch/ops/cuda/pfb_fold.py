"""Polyphase filterbank fold: fold[t, r] = Σ_k G[k, r]·rows[t + k, r].

Counterpart of `supersdr_tpu/ops/pallas/pfb_fold.py` (`pfb_fold_c`,
`fold_taps`, `channelize_pallas_c`). With critical sampling the PFB's
windowed sum is a K-tap depthwise convolution down the rows of carry ‖ x
reshaped [nf + K − 1, M]. The kernel is `csrc/pfb_fold.cu`;
`pfb_fold_plain` is the same function in plain PyTorch (products and sums
rounded in the same order, so the two agree bit for bit). `pfb_fold` runs
the plain version for CPU tensors and the kernel for CUDA tensors. Both
take an optional leading shard axis (D time shards, each with its own
carry: the mesh form of the wideband fallback tier), one launch for all.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from supersdr_tpu_torch import _build
from supersdr_tpu_torch.ops import channelizer, cx


def fold_taps(plan: channelizer.PFBPlan, proto: np.ndarray,
              device=None) -> torch.Tensor:
    """The prototype arranged for the fold: G[k, r] = h_rev[k·M + r]."""
    g = np.asarray(proto)[::-1]
    return torch.from_numpy(np.ascontiguousarray(
        g.reshape(plan.taps_per, plan.n_chan), np.float32)).to(device)


def pfb_fold_plain(G: torch.Tensor, carry_r: torch.Tensor,
                   carry_i: torch.Tensor, x_r: torch.Tensor,
                   x_i: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch fold (see `pfb_fold`) → complex64 [*D, nf, M]."""
    K, M = G.shape
    *lead, n = x_r.shape
    nf = n // M

    def fold(c, x):
        rows = torch.cat([c.reshape(*lead, K - 1, M),
                          x.reshape(*lead, nf, M)], dim=-2)
        acc = G[0] * rows[..., 0:nf, :]
        for k in range(1, K):
            acc = acc + G[k] * rows[..., k:k + nf, :]
        return acc
    return torch.complex(fold(carry_r, x_r), fold(carry_i, x_i))


def _launch(G, carry_r, carry_i, x_r, x_i):
    lib = _build.load()
    K, M = G.shape
    if K > lib.pfb_fold_max_taps():
        raise ValueError(f"the kernel folds at most "
                         f"{lib.pfb_fold_max_taps()} taps a branch, got {K}")
    *lead, n = x_r.shape
    nf = n // M
    out = torch.empty(*lead, nf, M, dtype=torch.complex64, device=x_r.device)
    p = ctypes.c_void_p
    err = lib.pfb_fold(
        p(G.data_ptr()), p(carry_r.data_ptr()), p(carry_i.data_ptr()),
        p(x_r.data_ptr()), p(x_i.data_ptr()), p(out.data_ptr()), nf, M, K,
        lead[0] if lead else 1,
        p(torch.cuda.current_stream(x_r.device).cuda_stream))
    _build.check(err, "pfb_fold")
    pfb_fold.launches += 1
    return out


def pfb_fold(plan: channelizer.PFBPlan, G: torch.Tensor, carry: cx.CX,
             x: cx.CX) -> torch.Tensor:
    """The WOLA fold of one critically sampled chunk.

    G: [K, M] float32 fold taps (`fold_taps`); carry: CX of the (K−1)·M
    history planes; x: CX of [n] float32 planes, n a positive multiple of
    M; or carry [D, (K−1)·M] and x [D, n], D time shards each with its own
    history. Returns fold [*D, n/M, M] complex64. CPU tensors run the
    plain version, CUDA tensors the kernel."""
    M, K = plan.n_chan, plan.taps_per
    if plan.hop != M:
        raise ValueError("the fold requires critical sampling (hop = M)")
    *lead, n = x.re.shape
    if len(lead) > 1:
        raise ValueError("x takes at most one leading (shard) axis")
    if n % M or n == 0:
        raise ValueError("block length must be a positive multiple of "
                         "n_chan")
    dev = G.device
    for name, t, shape in (("G", G, (K, M)),
                           ("carry.re", carry.re, (*lead, plan.history)),
                           ("carry.im", carry.im, (*lead, plan.history)),
                           ("x.re", x.re, (*lead, n)),
                           ("x.im", x.im, (*lead, n))):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    args = (G, carry.re, carry.im, x.re, x.im)
    if dev.type == "cpu":
        return pfb_fold_plain(*args)
    if dev.type == "cuda":
        return _launch(*args)
    raise ValueError(f"unsupported device {dev}")


pfb_fold.launches = 0


def channelize_pallas_c(plan: channelizer.PFBPlan, G: torch.Tensor,
                        carry: cx.CX, x: cx.CX
                        ) -> tuple[cx.CX, torch.Tensor]:
    """The channelizer through the fold kernel: fold, `torch.fft` over the
    M channels, then the move to [M, n_frames] (critical sampling needs no
    phase correction). Returns (new carry CX, chans complex64 [M, nf]);
    with a leading shard axis on carry and x, each shard's new carry and
    chans [D, M, nf]."""
    spec = torch.fft.fft(pfb_fold(plan, G, carry, x), dim=-1)
    h, n = plan.history, x.re.shape[-1]
    if n >= h:
        new_carry = cx.CX(x.re[..., n - h:].clone(), x.im[..., n - h:].clone())
    else:
        new_carry = cx.CX(torch.cat([carry.re, x.re], dim=-1)[..., n:],
                          torch.cat([carry.im, x.im], dim=-1)[..., n:])
    return new_carry, spec.transpose(-1, -2)
