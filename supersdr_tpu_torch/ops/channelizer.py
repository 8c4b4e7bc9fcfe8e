"""Polyphase filterbank channelizer: host-side plan and tables.

Counterpart of `supersdr_tpu/ops/channelizer.py`. The planar wideband
path runs the filterbank (fold + both DIF FFT stages) as the kernel in
`ops/cuda/channelize_fused.py`; the chan-major tiers run `channelize_c` /
`channelize_mxu2_c` here (the K-tap fold as shifted row slices, then
`torch.fft` over the channel axis — cuFFT on the card) or the fold kernel
of `ops/cuda/pfb_fold.py`.

Critically sampled WOLA filterbank: channel m is centred at m·fs/M
(wrapped to ±fs/2); the M-point DFT is factored M = n1·n2 with DIF
indexing r = j1·n2 + j2 (input column) and m = k2·n1 + k1 (bin).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from supersdr_tpu_torch.ops import cx, firdesign

MAX_DIRECT = 256   # largest DFT factor (the reference's cx.MAX_DIRECT)


@dataclass(frozen=True)
class PFBPlan:
    """n_chan: channels M; taps_per: prototype taps per branch K;
    hop: input samples per output frame (M for critical sampling)."""
    n_chan: int
    taps_per: int
    hop: int

    @property
    def window_len(self) -> int:
        return self.n_chan * self.taps_per

    @property
    def history(self) -> int:
        return self.window_len - self.hop


@lru_cache(maxsize=64)
def design(n_chan: int, taps_per: int = 8, osr: int = 1,
           cutoff_scale: float = 1.0) -> tuple[PFBPlan, np.ndarray]:
    """Prototype lowpass (Blackman-windowed sinc, cutoff
    cutoff_scale·fs/(2M), unity DC gain per channel) and plan."""
    if osr not in (1, 2, 4):
        raise ValueError("osr must be 1, 2 or 4")
    if n_chan % osr:
        raise ValueError("n_chan must be divisible by osr")
    n = n_chan * taps_per
    if n % 2 == 0:
        # the design rule wants odd lengths: design at n+1, drop the last
        proto = firdesign.lowpass_taps_n(cutoff_scale * 0.5 / n_chan, 1.0,
                                        n + 1)[:-1]
    else:
        proto = firdesign.lowpass_taps_n(cutoff_scale * 0.5 / n_chan, 1.0, n)
    proto = proto / proto.sum()
    plan = PFBPlan(n_chan=n_chan, taps_per=taps_per, hop=n_chan // osr)
    proto = proto.astype(np.float64)
    proto.setflags(write=False)   # the cached instance is shared
    return plan, proto


def taps_matrix(plan: PFBPlan, proto: np.ndarray,
                device=None) -> torch.Tensor:
    """Polyphase weights [taps_per, n_chan] float32 (row k = proto[k·M ..
    k·M+M)), the reference's `W_pfb`."""
    W = np.asarray(proto).reshape(plan.taps_per, plan.n_chan)
    return torch.from_numpy(W.astype(np.float32)).to(device)


def init_carry(plan: PFBPlan, batch_shape: tuple[int, ...] = (),
               device=None) -> cx.CX:
    """Zero filter history [*batch, history]."""
    return cx.zeros(batch_shape + (plan.history,), device=device)


def _fold_slices(g2: torch.Tensor, rows: torch.Tensor, n_frames: int
                 ) -> torch.Tensor:
    """fold[t, r] = Σ_k g2[k, r]·rows[t + k, r] (critical sampling)."""
    fold = g2[0] * rows[..., 0:n_frames, :]
    for k in range(1, g2.shape[0]):
        fold = fold + g2[k] * rows[..., k:k + n_frames, :]
    return fold


def channelize_c(plan: PFBPlan, W: torch.Tensor, carry: torch.Tensor,
                 x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One streaming step on complex tensors: x [*batch, n] (n a multiple
    of n_chan and of the hop) → (new carry, channels [*batch, n_chan,
    n/hop]); channel m is the band at m·fs/M, decimated to fs/hop, with
    the mixer phase referenced to the stream origin:
        y[m, t] = Σ_j proto[j]·x[t·hop − j]·e^{2πi·m·(t·hop − j)/M}."""
    n = x.shape[-1]
    M, K, hop = plan.n_chan, plan.taps_per, plan.hop
    if n % hop or n % M:
        raise ValueError("block length must be a multiple of the hop and "
                         "of n_chan")
    n_frames = n // hop
    seg = torch.cat([carry, x], dim=-1)
    g = W.reshape(-1).flip(0)
    if hop == M:
        rows = seg.reshape(*seg.shape[:-1], n_frames + K - 1, M)
        fold = _fold_slices(g.reshape(K, M), rows, n_frames)
    else:
        idx = (torch.arange(n_frames, device=x.device)[:, None] * hop
               + torch.arange(plan.window_len, device=x.device)[None, :])
        frames = seg[..., idx]                          # [.., nf, K·M]
        fold = (frames * g).reshape(*frames.shape[:-1], K, M).sum(-2)
    spec = torch.fft.fft(fold, dim=-1)                  # [.., nf, M]
    if hop != M:
        m = torch.arange(M, device=x.device)
        rot = (plan.history - torch.arange(n_frames, device=x.device
                                           )[:, None] * hop) % M
        spec = spec * torch.exp((2j * np.pi / M) * (m[None, :] * rot))
    return seg[..., -plan.history:], spec.transpose(-1, -2)


def mxu2_supported(M: int) -> bool:
    return M <= MAX_DIRECT or _pick_factors(M) is not None


def channelize_mxu2_c(plan: PFBPlan, W: torch.Tensor, carry: torch.Tensor,
                      x: torch.Tensor, *, fold_impl: str = "slices"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's lane-layout channelizer ([n] complex → (new carry,
    [M, n/M])): the fold as row slices, then the M-point DFT. The
    reference evaluates that DFT as two DIF matrix products at its
    precision tier; the port takes `torch.fft` in float32, which is that
    DFT to float32 rounding."""
    if fold_impl != "slices":
        raise NotImplementedError(
            f"fold_impl={fold_impl!r} is one of the reference's TPU A/B "
            "variants, not ported (ROADMAP queue 1, do-not-port list)")
    if plan.hop != plan.n_chan:
        raise ValueError("mxu2 channelizer requires critical sampling")
    if x.ndim != 1:
        raise ValueError("mxu2 channelizer is unbatched ([n] input)")
    return channelize_c(plan, W, carry, x)


def _pick_factors(M: int) -> tuple[int, int] | None:
    """(n1, n2) with M = n1·n2, both ≤ MAX_DIRECT, preferring n2 a
    multiple of 128 and as large as possible. None when M ≤ MAX_DIRECT
    or no such factoring exists."""
    if M <= MAX_DIRECT:
        return None
    for n2 in (256, 128):
        if M % n2 == 0 and M // n2 <= MAX_DIRECT:
            return (M // n2, n2)
    for n2 in range(min(MAX_DIRECT, M - 1), 0, -1):
        if M % n2 == 0 and M // n2 <= MAX_DIRECT:
            return (M // n2, n2)
    return None


@lru_cache(maxsize=32)
def _dif_tables(M: int, n1: int, n2: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stage-A matrix with the twiddle folded in, A[j2, k1, j1] =
    W_n1^{j1·k1}·W_M^{j2·k1}, and the stage-B DFT c2[j2, k2] = W_n2^{j2·k2}
    (re/im float32 planes): X[k2·n1 + k1] = Σ_j2 c2[j2, k2]·Σ_j1
    A[j2, k1, j1]·x[j1·n2 + j2]."""
    jk1 = np.outer(np.arange(n1), np.arange(n1))
    d1 = np.exp(-2j * np.pi * jk1 / n1)                    # [j1, k1]
    tw = np.exp(-2j * np.pi
                * np.outer(np.arange(n2), np.arange(n1)) / M)  # [j2, k1]
    A = d1.T[None, :, :] * tw[:, :, None]                  # [j2, k1, j1]
    jk2 = np.outer(np.arange(n2), np.arange(n2))
    c2 = np.exp(-2j * np.pi * jk2 / n2)                    # [j2, k2]
    return (A.real.astype(np.float32), A.imag.astype(np.float32),
            c2.real.astype(np.float32), c2.imag.astype(np.float32))


@lru_cache(maxsize=32)
def _stageb_split_tables(n2: int, levels: int = 1
                         ) -> tuple[np.ndarray, np.ndarray, tuple]:
    """Tables of the reference's L-level radix-2 DIF split of stage B:
    the n2/2^L-point DFT matrix and, per level, the twiddle row pair
    (tw_r[1, w], tw_i[1, w]). The port runs stage B unsplit (see
    `runtime.wideband._split_levels_for`); these tables and
    `stageb_col_to_k2` read the reference's split output."""
    nL = n2 >> levels
    jk = np.outer(np.arange(nL), np.arange(nL))
    c2L = np.exp(-2j * np.pi * jk / nL)
    tws = []
    for lev in range(levels):
        W = n2 >> lev
        tw = np.exp(-2j * np.pi * np.arange(W // 2) / W)
        tws.append((tw.real.astype(np.float32)[None, :],
                    tw.imag.astype(np.float32)[None, :]))
    return (c2L.real.astype(np.float32), c2L.imag.astype(np.float32),
            tuple(tws))


def stageb_split_ok(n2: int, levels: int = 1) -> bool:
    """The reference's split needs every block 128-aligned at every
    level."""
    return levels >= 1 and n2 % (128 << levels) == 0


def stageb_col_to_k2(n2: int, levels) -> np.ndarray:
    """k2 as a function of the raw output column: identity without the
    split; with L levels, col = b·(n2/2^L) + r holds k2 = r·2^L +
    bitrev_L(b)."""
    L = int(levels)
    if L <= 0:
        return np.arange(n2)
    wL = n2 >> L
    c = np.arange(n2)
    b, r = c // wL, c % wL
    rev = np.zeros_like(b)
    for i in range(L):
        rev |= ((b >> (L - 1 - i)) & 1) << i
    return r * (1 << L) + rev


def channel_center_freqs(plan: PFBPlan, fs: float) -> np.ndarray:
    """Centre frequency (Hz, wrapped to ±fs/2) of each channel index."""
    m = np.arange(plan.n_chan)
    f = m * fs / plan.n_chan
    f[f >= fs / 2] -= fs
    return f
