"""Demodulators: AM / SSB (USB, LSB) / CW / NBFM / IQ.

Counterpart of `supersdr_tpu/ops/demod.py`, on the passband-filtered
complex baseband:

  USB/LSB/CW  audio = Re{y} (the one-sided passband makes y analytic)
  AM          envelope |y|, then a one-pole DC blocker
  NBFM        angle(y[n]·conj(y[n−1]))·fs/(2π·max_dev), muted where
              |Re|+|Im| of the product is at most NBFM_MUTE_FLOOR
  IQ          pass-through

Every demod is (state, y) → (state, audio). The fused chain tail
(`ops/cuda/chain_tail.py`) runs the AM/SSB/NBFM forms inside its kernel.
With `shard_axis=-2` (the reference's `axis_name`) y is `[*batch, D,
n_local]`, time-sharded: NBFM's previous sample and AM's DC block cross
the shard boundaries, the state seeds shard 0, and the returned state
holds every shard's (`[*batch, D]`; the stream's is the last one).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from supersdr_tpu_torch.ops import cx, scans

# below this |Re p|+|Im p| of p = y[n]·conj(y[n−1]) the angle is
# numerical noise, so the discriminator outputs 0 (as the reference)
NBFM_MUTE_FLOOR = 1e-12
MODE_IDS = {"USB": 0, "LSB": 0, "CW": 0, "AM": 1, "NBFM": 2}


class DemodState(NamedTuple):
    """last_sample: previous complex input (NBFM); dc_x, dc_y: DC-blocker
    state (AM). Fields a mode does not use stay as they are."""
    last_sample: cx.CX
    dc_x: torch.Tensor
    dc_y: torch.Tensor


def init_state(batch_shape: tuple[int, ...] = (), device=None) -> DemodState:
    f = torch.zeros(batch_shape, dtype=torch.float32, device=device)
    return DemodState(last_sample=cx.zeros(batch_shape, device=device),
                      dc_x=f, dc_y=f.clone())


def demod_ssb(state: DemodState, y: torch.Tensor
              ) -> tuple[DemodState, torch.Tensor]:
    return state, y.real.float()


def demod_am(state: DemodState, y: torch.Tensor, dc_r: float = 0.999,
             shard_axis: int | None = None, halo_impl: str = "rdma"
             ) -> tuple[DemodState, torch.Tensor]:
    audio, (dc_x, dc_y) = scans.dc_block(y.abs().float(), dc_r, state.dc_x,
                                         state.dc_y, shard_axis=shard_axis,
                                         halo_impl=halo_impl)
    return state._replace(dc_x=dc_x, dc_y=dc_y), audio


def demod_nbfm(state: DemodState, y: torch.Tensor, fs: float,
               max_dev_hz: float = 5000.0, shard_axis: int | None = None,
               halo_impl: str = "rdma"
               ) -> tuple[DemodState, torch.Tensor]:
    if shard_axis is not None:
        # each shard's previous sample: the left neighbour's last one
        last = cx.CX(*(torch.broadcast_to(p, y.shape[:-2])[..., None]
                       .contiguous() for p in state.last_sample))
        first = scans.left_halo(y, 1, head0=last, impl=halo_impl)
    else:
        last = torch.complex(state.last_sample.re, state.last_sample.im)
        first = torch.broadcast_to(last, y[..., 0].shape)[..., None]
    prod = y * torch.conj(torch.cat([first, y[..., :-1]], dim=-1))
    mag = prod.real.abs() + prod.imag.abs()
    dphi = torch.where(mag > NBFM_MUTE_FLOOR, torch.angle(prod),
                       torch.zeros_like(mag))
    audio = dphi * (fs / (2.0 * np.pi * max_dev_hz))
    return state._replace(last_sample=cx.CX(y[..., -1].real.contiguous(),
                                            y[..., -1].imag.contiguous())
                          ), audio


def demod_iq(state: DemodState, y: torch.Tensor
             ) -> tuple[DemodState, torch.Tensor]:
    return state, y


def demodulate_runtime(state: DemodState, y: torch.Tensor, fs: float,
                       mode_id: torch.Tensor, max_dev_hz: float = 5000.0
                       ) -> tuple[DemodState, torch.Tensor]:
    """Per-slot demod select (`mode_id` [*batch]: 0 SSB/CW, 1 AM, 2
    NBFM): all three run and a where keeps each slot's own; only the
    selected branch's state advances."""
    _, ssb = demod_ssb(state, y)
    st_am, am = demod_am(state, y)
    st_fm, fm = demod_nbfm(state, y, fs, max_dev_hz)
    sel_b = torch.as_tensor(mode_id, device=y.device)
    sel = sel_b[..., None]
    audio = torch.where(sel == 1, am, torch.where(sel == 2, fm, ssb))
    st = DemodState(
        last_sample=cx.CX(
            torch.where(sel_b == 2, st_fm.last_sample.re,
                        state.last_sample.re),
            torch.where(sel_b == 2, st_fm.last_sample.im,
                        state.last_sample.im)),
        dc_x=torch.where(sel_b == 1, st_am.dc_x, state.dc_x),
        dc_y=torch.where(sel_b == 1, st_am.dc_y, state.dc_y))
    return st, audio


def demodulate(mode: str, state: DemodState, y: torch.Tensor, fs: float,
               max_dev_hz: float = 5000.0, shard_axis: int | None = None,
               halo_impl: str = "rdma") -> tuple[DemodState, torch.Tensor]:
    """Dispatch by mode name."""
    mode = mode.upper()
    if mode in ("USB", "LSB", "CW"):
        return demod_ssb(state, y)
    if mode == "AM":
        return demod_am(state, y, shard_axis=shard_axis,
                        halo_impl=halo_impl)
    if mode == "NBFM":
        return demod_nbfm(state, y, fs, max_dev_hz=max_dev_hz,
                          shard_axis=shard_axis, halo_impl=halo_impl)
    if mode == "IQ":
        return demod_iq(state, y)
    raise ValueError(f"unknown mode {mode!r}")
