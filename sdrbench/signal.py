"""The one generator of every traffic mix: a wideband sc16 capture made on
the device from a seed.

The capture is complex Gaussian noise plus AM carriers at the centres of
one channel in `carrier_every` (the channel within each group drawn from
the seed), each with a log-uniform amplitude, a modulation depth, a tone
and two phases drawn from the seed. A carrier at bin b is periodic over a
frame of M samples, so writing n = t·M + r the capture is

    s[t, r] = Σ_c A_c·e^{iφ_c}·W^{b_c·r}·(1 + μ_c·cos(ω_c·(t·M + r) + θ_c))

with W = e^{2πi/M}: a constant row plus a product of a [frames, 2C] and a
[2C, M] matrix (the cosine as two exponentials), which the device computes
in float32 with TF32 off. It is then quantized to int16 (±32768 ≡ ±1.0),
saturating; the clipped samples are counted.

A `keying` block {"share", "period_chunks", "on_chunks"} keys a share of
the carriers (drawn from the seed) on and off at chunk boundaries: carrier
c sounds in chunk k where (k + o_c) mod period_chunks < on_chunks, o_c
drawn from the seed, and is silent otherwise, its phase running on. The
constant row is then a [frames, C] by [C, M] product too. Without the
block every carrier sounds throughout.

Every seed gives the same sizes and carrier count (and keyed count), only
other values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

I16_FULL = 32768.0
BLOCK_FRAMES = 4096


class Capture(NamedTuple):
    re: torch.Tensor          # int16 [n_chunks, chunk_in]
    im: torch.Tensor
    carrier_bins: np.ndarray  # the bins that hold a carrier
    clipped: int
    keys: np.ndarray | None   # bool [carriers, n_chunks]: each sounds;
                              # None without keying


def _keys(key: dict, groups: int, n_chunks: int, rng: np.random.Generator
          ) -> np.ndarray:
    """[groups, n_chunks] bool: whether each carrier sounds in each chunk."""
    period = key["period_chunks"]
    keyed = rng.choice(groups, round(key["share"] * groups), replace=False)
    phase = rng.integers(0, period, len(keyed))
    on = np.ones((groups, n_chunks), dtype=bool)
    on[keyed] = (np.arange(n_chunks) + phase[:, None]) % period \
        < key["on_chunks"]
    return on


def _carriers(sig: dict, n_chan: int, fs: float, rng: np.random.Generator
              ) -> dict:
    every = sig["carrier_every"]
    groups = n_chan // every
    bins = np.arange(groups) * every + rng.integers(0, every, groups)
    lo, hi = sig["carrier_amp"]
    amp = np.exp(rng.uniform(np.log(lo), np.log(hi), groups))
    depth = rng.uniform(*sig["mod_depth"], groups)
    tone = rng.uniform(*sig["tone_hz"], groups)
    return dict(bins=bins, amp=amp, depth=depth,
                omega=2.0 * np.pi * tone / fs,
                phi=rng.uniform(0.0, 2.0 * np.pi, groups),
                theta=rng.uniform(0.0, 2.0 * np.pi, groups))


def make_capture(sig: dict, n_chan: int, fs: float, n_chunks: int,
                 frames: int, seed: int, device) -> Capture:
    """`n_chunks` consecutive chunks of `frames`·n_chan samples each."""
    rng = np.random.default_rng(seed)
    car = _carriers(sig, n_chan, fs, rng)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 63)))
    keys = (_keys(sig["keying"], len(car["bins"]), n_chunks, rng)
            if "keying" in sig else None)
    M = n_chan
    r = np.arange(M)
    # [C, M] rows: the carrier at its bin, and its two sidebands
    wb = np.exp(2j * np.pi * np.outer(car["bins"], r) / M)
    a = (car["amp"] * np.exp(1j * car["phi"]))[:, None]
    base = (a * wb).sum(0)
    side = 0.5 * car["depth"][:, None] * a * wb
    w_r = np.outer(car["omega"], r)
    V = np.concatenate([side * np.exp(1j * w_r), side * np.exp(-1j * w_r)])
    f32 = dict(dtype=torch.float32, device=device)
    omega = torch.tensor(car["omega"], dtype=torch.float64, device=device)
    theta = torch.tensor(car["theta"], dtype=torch.float64, device=device)
    Vr, Vi = torch.tensor(V.real, **f32), torch.tensor(V.imag, **f32)
    base_r = torch.tensor(base.real, **f32)
    base_i = torch.tensor(base.imag, **f32)
    if keys is not None:
        # each carrier's constant row, and its switch chunk by chunk
        aw = a * wb
        Br, Bi = torch.tensor(aw.real, **f32), torch.tensor(aw.imag, **f32)
        K = torch.tensor(keys, **f32)
    total = n_chunks * frames
    re = torch.empty(total, M, dtype=torch.int16, device=device)
    im = torch.empty_like(re)
    clipped = torch.zeros((), dtype=torch.int64, device=device)
    sigma = sig["noise_rms"]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t0 in range(0, total, BLOCK_FRAMES):
            nt = min(total, t0 + BLOCK_FRAMES) - t0
            t = torch.arange(t0, t0 + nt, dtype=torch.float64, device=device)
            ph = torch.remainder(torch.outer(t * M, omega) + theta,
                                 2.0 * np.pi)
            Ur, Ui = torch.cos(ph).float(), torch.sin(ph).float()
            b_r, b_i = base_r, base_i
            if keys is not None:
                k = K[:, t.long() // frames].T              # [nt, C]
                Ur, Ui = Ur * k, Ui * k
                b_r, b_i = k @ Br, k @ Bi
            # cos terms: U = e^{i·ph} against the + rows, conj against −
            U_r = torch.cat([Ur, Ur], 1)
            U_i = torch.cat([Ui, -Ui], 1)
            for out, b, p, q, sgn in ((re, b_r, Vr, Vi, -1.0),
                                      (im, b_i, Vi, Vr, 1.0)):
                x = U_r @ p + sgn * (U_i @ q) + b
                x += sigma * torch.randn(x.shape, generator=gen, **f32)
                v = torch.round(x * I16_FULL)
                clipped += ((v > 32767) | (v < -32768)).sum()
                out[t0:t0 + nt] = v.clamp(-32768, 32767).to(torch.int16)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    chunk_in = frames * M
    return Capture(re=re.reshape(n_chunks, chunk_in),
                   im=im.reshape(n_chunks, chunk_in),
                   carrier_bins=car["bins"], clipped=int(clipped),
                   keys=keys)
