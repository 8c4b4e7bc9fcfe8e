"""The plain reference of the wideband receiver, in float64 PyTorch.

One capture of sc16 IQ (±32768 ≡ ±1.0) → critically sampled polyphase
channelizer (M channels of fs/M, the K-tap fold and an M-point DFT) →
per channel: the complex passband FIR, the RSSI of the filtered signal,
the demodulator of the configuration's mode (`modes/<mode>.py`, the AGC
with it), the L× polyphase interpolator to the audio rate and, where the
deployment has a `squelch` block, the squelch gate on the audio, chunk by
chunk (`squelch.py`). Every recursion runs on explicit state, so a stream
cut into any blocks gives the same result as one block.

Written from the configuration's numbers alone: it imports nothing of the
program and takes none of its tables. `rnd`, where given, rounds the
channelizer's DFT operands, its output planes and the FIR's operands to a
lower precision (the control of `sdrbench/reference/precision.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdrbench.reference import design, modes, squelch

I16_SCALE = 1.0 / 32768.0


class Tables(NamedTuple):
    M: int
    K: int
    n_taps: int
    g2: torch.Tensor        # [K, M] fold weights, row k for rows[t + k]
    h: torch.Tensor         # [n_taps] complex passband taps
    P: torch.Tensor         # [per, L] interpolator
    cal_db: float
    floor_db: float
    mode: object            # the demodulator's module
    mt: object              # its tables
    sq: squelch.SquelchTables | None    # the gate's; None without one


class RefState(NamedTuple):
    """Stream state, channels in bin order."""
    pfb: torch.Tensor       # complex128 [(K−1)·M] input history
    os: torch.Tensor        # complex128 [M, n_taps − 1] FIR history
    interp: torch.Tensor    # float64 [M, per − 1] interpolator history
    leaves: dict            # the demodulator's and the gate's,
                            # {leaf: float64 [M]}


class Step(NamedTuple):
    state: RefState
    audio: torch.Tensor     # float64 [M, nf·L]
    rssi: torch.Tensor      # dB [M, chunks], a column a chunk
    gate: squelch.Decisions  # what the gate decided


def make_tables(dep: dict, device) -> Tables:
    """From a configuration's `deployment` block."""
    M, K = dep["n_chan"], dep["taps_per"]
    iq_rate = dep["fs_in"] // M
    proto = design.pfb_prototype(M, K)
    mode = modes.load(dep["mode"])
    P = design.interp_matrix(iq_rate, dep["audio_rate"])
    f64 = dict(dtype=torch.float64, device=device)
    return Tables(
        M=M, K=K, n_taps=dep["n_taps"],
        g2=torch.tensor(proto[::-1].copy().reshape(K, M), **f64),
        h=torch.tensor(design.passband_taps(mode.PASSBAND, iq_rate,
                                            dep["n_taps"]),
                       dtype=torch.complex128, device=device),
        P=torch.tensor(P, **f64),
        cal_db=dep["rssi_cal_db"], floor_db=dep["rssi_floor_db"],
        mode=mode, mt=mode.tables(dep, iq_rate),
        sq=squelch.tables(dep["squelch"], P.shape[1])
        if "squelch" in dep else None)


def zero_state(t: Tables, device) -> RefState:
    M = t.M
    return RefState(
        pfb=torch.zeros((t.K - 1) * M, dtype=torch.complex128, device=device),
        os=torch.zeros(M, t.n_taps - 1, dtype=torch.complex128,
                       device=device),
        interp=torch.zeros(M, t.P.shape[0] - 1, dtype=torch.float64,
                           device=device),
        leaves=t.mode.zero(M, device)
        | (squelch.zero(M, device) if t.sq is not None else {}))


def dft_matrix(M: int, device) -> torch.Tensor:
    """[M, M] complex128, W[r, m] = e^{−2πi·r·m/M}."""
    r = torch.arange(M, dtype=torch.float64, device=device)
    ang = (-2.0 * torch.pi / M) * torch.remainder(torch.outer(r, r), M)
    return torch.polar(torch.ones_like(ang), ang)


def _complex_round(rnd, z: torch.Tensor) -> torch.Tensor:
    return torch.complex(rnd(z.real), rnd(z.imag))


def step(t: Tables, st: RefState, re16: torch.Tensor, im16: torch.Tensor,
         chunk_frames: int, rnd=None, edge_rssi: torch.Tensor | None = None,
         margin: float = 0.0) -> Step:
    """One block of n = nf·M samples (int16 planes on the tables' device),
    nf a multiple of `chunk_frames`, bins in order. `edge_rssi` [M, nf /
    chunk_frames], a system's RSSI for the block's chunks, takes the
    gate's decision wherever the reference's RSSI lies within `margin` dB
    of a threshold (`squelch.apply`)."""
    M, K, ov = t.M, t.K, t.n_taps - 1
    x = torch.complex(re16.double(), im16.double()) * I16_SCALE
    nf = x.numel() // M
    seg = torch.cat([st.pfb, x])
    rows = seg.reshape(nf + K - 1, M)
    fold = t.g2[0] * rows[0:nf]
    for k in range(1, K):
        fold += t.g2[k] * rows[k:k + nf]
    del rows, x
    h = t.h
    if rnd is None:
        chans = torch.fft.fft(fold, dim=-1).T              # [M, nf]
    else:
        # the DFT as a product whose two operands are rounded
        h = _complex_round(rnd, h)
        chans = _complex_round(rnd, (_complex_round(rnd, fold)
                                     @ _complex_round(rnd, dft_matrix(M,
                                                      fold.device))).T)
    del fold
    xe = torch.cat([st.os, chans], dim=1)                  # [M, ov + nf]
    del chans
    n = xe.shape[1]
    y = torch.fft.ifft(torch.fft.fft(xe, dim=1)
                       * torch.fft.fft(h, n=n), dim=1)[:, ov:]
    pw = (y.real ** 2 + y.imag ** 2).reshape(M, nf // chunk_frames,
                                             chunk_frames).mean(-1)
    rssi = torch.clamp_min(10.0 * torch.log10(torch.clamp_min(pw, 1e-30))
                           + t.cal_db, t.floor_db)
    x, leaves = t.mode.demod(t.mt, y, st.leaves)
    del y
    per, L = t.P.shape
    seg2 = torch.cat([st.interp, x], dim=1)
    audio = seg2[:, 0:nf, None] * t.P[0]
    for m in range(1, per):
        audio += seg2[:, m:m + nf, None] * t.P[m]
    audio = audio.reshape(M, nf * L)
    made = squelch.NONE
    if t.sq is not None:
        audio, sq_leaves, made = squelch.apply(t.sq, audio, rssi,
                                               st.leaves, edge_rssi, margin)
        leaves |= sq_leaves
    new = RefState(pfb=seg[-(K - 1) * M:].clone(), os=xe[:, -ov:].clone(),
                   interp=seg2[:, -(per - 1):].clone(), leaves=leaves)
    return Step(new, audio, rssi, made)
