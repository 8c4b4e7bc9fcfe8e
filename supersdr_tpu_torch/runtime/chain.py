"""Receiver chain: configuration, parameters, state and the fused
time-major tail.

Counterpart of `supersdr_tpu/runtime/chain.py` for what the planar
wideband path reads: `ChainConfig`, `ChainParams` (the in-tail passband
matrix, the polyphase resampler, AGC and squelch), `ChainState` (field for
field the reference's, so a state moves between the packages unchanged)
and `process_tail_tmajor` with the channelizer's raw planes (`fir_x3`).
The chain's own per-receiver path (`process`) is ROADMAP queue 1 #4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from supersdr_tpu.ops import firdesign, passband
from supersdr_tpu_torch.ops import agc as agc_ops
from supersdr_tpu_torch.ops import cx
from supersdr_tpu_torch.ops import demod as demod_ops
from supersdr_tpu_torch.ops import fir_matmul, mixer, overlap_save, resample
from supersdr_tpu_torch.ops import smeter
from supersdr_tpu_torch.ops import squelch as squelch_ops
from supersdr_tpu_torch.ops.cuda import chain_tail


@dataclass(frozen=True)
class ChainConfig:
    """Static chain structure; field names and defaults as the reference's
    (the impl/precision strings name the reference's tiers)."""
    mode: str = "AM"
    iq_rate: int = 12000
    audio_rate: int = 48000
    chunk: int = 2048
    os_block: int = 2048
    n_taps: int = 513
    hang_ms: float = 500.0
    hang_enabled: bool = False
    agc_decimation: int = 1
    max_dev_hz: float = 5000.0
    squelch_enabled: bool = False
    nco_enabled: bool = True
    passband_impl: str = "fft"
    passband_precision: str = "highest"
    resample_impl: str = "einsum"
    resample_precision: str = "highest"
    tail_impl: str = "xla"

    def __post_init__(self):
        if self.chunk % self.os_block:
            raise ValueError("chunk must be a multiple of os_block")
        if self.n_taps % 2 == 0:
            raise ValueError("n_taps must be odd")

    @property
    def os_plan(self) -> overlap_save.OSPlan:
        return overlap_save.plan_for(self.os_block, self.n_taps)

    @property
    def is_rational(self) -> bool:
        return self.audio_rate % self.iq_rate != 0

    @property
    def upsample(self) -> int:
        if self.is_rational:
            raise ValueError("non-integer rate ratio")
        return self.audio_rate // self.iq_rate

    @property
    def audio_chunk(self) -> int:
        return self.chunk * self.upsample

    @property
    def interp_plan(self) -> resample.InterpPlan:
        plan, _ = resample.design_interp(self.iq_rate, self.audio_rate)
        return plan


class ChainParams(NamedTuple):
    P_interp: torch.Tensor            # [per, L] polyphase matrix
    agc: agc_ops.AGCParams
    squelch: squelch_ops.SquelchParams
    W_tailpass: torch.Tensor | None   # in-tail passband: real [W, B] or
                                      # complex-folded [2W, 2B]


class ChainState(NamedTuple):
    phase: torch.Tensor
    os_carry: cx.CX                   # [*batch, n_taps−1] input history
    demod: demod_ops.DemodState
    agc: agc_ops.AGCState
    interp_carry: torch.Tensor        # [*batch, per−1] resampler tail
    squelch: squelch_ops.SquelchState


class ChainOutput(NamedTuple):
    audio: torch.Tensor
    rssi: torch.Tensor
    baseband: cx.CX | None


def make_params(cfg: ChainConfig, delta_low: float = 0.0,
                delta_high: float = 0.0, low_cut: float | None = None,
                high_cut: float | None = None,
                agc_kwargs: dict | None = None,
                squelch_kwargs: dict | None = None,
                device=None) -> ChainParams:
    """Host-side build (float64 design, float32 tensors on `device`)."""
    if cfg.is_rational:
        raise NotImplementedError(
            "rational resampling is not ported yet (ROADMAP queue 1 #4, "
            "the receiver chain)")
    if low_cut is None or high_cut is None:
        lc, hc = passband.supersdr_passband(cfg.mode, delta_low, delta_high)
    else:
        lc, hc = low_cut, high_cut
    taps = firdesign.complex_bandpass_taps(lc, hc, cfg.iq_rate, n=cfg.n_taps)
    itaps = firdesign.lowpass_taps(cfg.iq_rate / 2, cfg.audio_rate)
    _, P = resample.plan_interp(cfg.upsample, itaps)
    W_tailpass = None
    if cfg.passband_impl == "matmul":
        bn = fir_matmul.tail_fir_block(cfg.chunk, cfg.n_taps,
                                       _tail_tile(cfg.chunk, cfg.n_taps))
        if bn is not None:
            B, n_prev = bn
            w = (fir_matmul.build_w_free_real(B, n_prev, taps)
                 if fir_matmul.taps_are_real(taps)
                 else fir_matmul.build_w_free(B, n_prev, taps))
            W_tailpass = torch.from_numpy(w).to(device)
    return ChainParams(
        P_interp=torch.from_numpy(P.astype(np.float32)).to(device),
        agc=agc_ops.make_params(cfg.iq_rate, **(agc_kwargs or {}),
                                device=device),
        squelch=squelch_ops.make_squelch(**(squelch_kwargs or {}),
                                         device=device),
        W_tailpass=W_tailpass)


def init_state(cfg: ChainConfig, batch_shape: tuple[int, ...] = (),
               device=None) -> ChainState:
    return ChainState(
        phase=mixer.init_phase(batch_shape, device=device),
        os_carry=overlap_save.init_carry(cfg.os_plan, batch_shape,
                                         device=device),
        demod=demod_ops.init_state(batch_shape, device=device),
        agc=agc_ops.init_state(batch_shape, device=device),
        interp_carry=resample.init_carry(cfg.interp_plan, batch_shape,
                                         device=device),
        squelch=squelch_ops.init_squelch(batch_shape, device=device))


def _tail_tile(chunk: int, n_taps: int | None = None) -> int:
    """The reference's tail tile: a chunk divisor ≤ 1008, multiple of 8,
    with the smallest in-tail FIR block (ties to the larger tile). The
    port's plain tail scans in these tiles; its kernel does not tile
    time this way."""
    cands = [t for t in range(8, 1009, 8) if chunk % t == 0]
    if not cands:
        return 0
    if n_taps is None:
        return cands[-1]
    best = None
    for t in cands:
        bn = fir_matmul.tail_fir_block(chunk, n_taps, t)
        flops = (bn[1] + 1) * bn[0] if bn is not None else 1 << 30
        key = (flops, -t)
        if best is None or key < best[0]:
            best = (key, t)
    return best[1]


def _pallas_tail_ok(cfg: ChainConfig, batch: tuple) -> bool:
    """The reference's predicate for its fused tail (the tier the port's
    tail kernel serves)."""
    return (cfg.mode.upper() in ("AM", "USB", "LSB", "CW", "NBFM")
            and not cfg.is_rational
            and cfg.agc_decimation == 1
            and len(batch) == 1 and batch[0] >= 128
            and _tail_tile(cfg.chunk, cfg.n_taps) >= 8)


def _tail_demod(cfg: ChainConfig) -> str:
    return {"AM": "am", "USB": "ssb", "LSB": "ssb", "CW": "ssb",
            "NBFM": "nbfm"}[cfg.mode.upper()]


def _tail_params_vec(params: ChainParams, cfg: ChainConfig) -> torch.Tensor:
    """[8] float32: slot 0 is the AM DC pole or, for NBFM, the
    discriminator scale fs/(2π·max_dev); then the AGC scalars. The hang
    flag is not a slot: hang is not in this tail."""
    ag = params.agc
    # torch.full fills on the device: a host copy would wait for the card
    slot0 = torch.full((), cfg.iq_rate / (2.0 * np.pi * cfg.max_dev_hz)
                       if cfg.mode.upper() == "NBFM" else 0.999,
                       dtype=torch.float32, device=ag.on.device)
    return torch.stack([slot0, ag.decay_per_sample_db, ag.thresh_db,
                        ag.slope_db, ag.target_db, ag.man_gain_db, ag.on,
                        ag.attack_coeff]).to(torch.float32)


def process_tail_tmajor(cfg: ChainConfig, params: ChainParams,
                        state: ChainState, phase: torch.Tensor,
                        os_carry: cx.CX, *, fir_x3: tuple,
                        chan_order: torch.Tensor,
                        audio_dtype: torch.dtype = torch.float32
                        ) -> tuple[ChainState, torch.Tensor, torch.Tensor]:
    """Time-major fused back half on the channelizer's raw planes.

    fir_x3: (raw_r, raw_i) [n1, chunk, n2]; audio and RSSI rows come out
    in planar channel order, and `chan_order` (row → bin, an index tensor
    on the planes' device) permutes the bin-ordered ChainState in and
    out. `os_carry` is the new input
    history (bin order) for the next chunk. Returns (state,
    audioT [chunk·L, C], rssi [C, 1])."""
    if cfg.chunk != cfg.os_block:
        raise ValueError("time-major tail needs os_block == chunk")
    if cfg.hang_enabled or cfg.squelch_enabled:
        raise NotImplementedError(
            "AGC hang and squelch on the fused tail are not ported yet "
            "(ROADMAP queue 1 #1, #2)")
    if params.W_tailpass is None:
        raise ValueError("params.W_tailpass missing (passband_impl must "
                         "be 'matmul' with a fusable FIR block)")
    raw_r, raw_i = fir_x3
    n1, _, n2 = raw_r.shape
    C = n1 * n2
    dev = raw_r.device
    order = chan_order
    inv = torch.argsort(order)
    PER = cfg.interp_plan.per
    tile = _tail_tile(cfg.chunk, cfg.n_taps)
    B, n_prev = fir_matmul.tail_fir_block(cfg.chunk, cfg.n_taps, tile)
    rb = 32 if tile % 32 == 0 else (16 if tile % 16 == 0 else 0)
    nbfm = cfg.mode.upper() == "NBFM"
    r0 = state.demod.last_sample.re if nbfm else state.demod.dc_x
    r1 = state.demod.last_sample.im if nbfm else state.demod.dc_y
    st_rows = torch.cat([
        torch.stack([r0, r1, state.agc.peak_db, state.agc.gain_db])[:, order],
        state.interp_carry[order].T,
        torch.zeros(1, C, dtype=torch.float32, device=dev),
    ]).contiguous()
    audioT, st2 = chain_tail.chain_tail_fir(
        raw_r, raw_i,
        state.os_carry.re[order].T.contiguous(),
        state.os_carry.im[order].T.contiguous(),
        st_rows, _tail_params_vec(params, cfg), params.W_tailpass,
        params.P_interp, n_taps=cfg.n_taps, B=B, n_prev=n_prev,
        tile_t=tile, demod=_tail_demod(cfg),
        fir_bf16=cfg.passband_precision == "default",
        rs_bf16=(cfg.resample_impl == "matmul" and rb != 0
                 and cfg.resample_precision == "default"))
    if audio_dtype != torch.float32:
        audioT = audioT.to(audio_dtype)
    pw = st2[4 + PER - 1] / cfg.chunk
    rssi = torch.clamp_min(
        10.0 * torch.log10(torch.clamp_min(pw, 1e-30)) + smeter.DEFAULT_CAL_DB,
        smeter.RSSI_FLOOR_DB)[:, None]
    o0, o1 = st2[0][inv], st2[1][inv]
    if nbfm:
        dstate = demod_ops.DemodState(last_sample=cx.CX(o0, o1),
                                      dc_x=state.demod.dc_x,
                                      dc_y=state.demod.dc_y)
    else:
        dstate = demod_ops.DemodState(last_sample=state.demod.last_sample,
                                      dc_x=o0, dc_y=o1)
    astate = agc_ops.AGCState(peak_db=st2[2][inv], gain_db=st2[3][inv])
    icarry = st2[4:4 + PER - 1].T[inv].contiguous()
    new_state = ChainState(phase=phase, os_carry=os_carry, demod=dstate,
                           agc=astate, interp_carry=icarry,
                           squelch=state.squelch)
    return new_state, audioT, rssi
