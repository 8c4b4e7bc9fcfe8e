"""Receiver chain: the IQ → audio demodulation program.

Counterpart of `supersdr_tpu/runtime/chain.py`: one function
`process(cfg, params, state, iq) -> (state, ChainOutput)` composing
blanker → NCO mix → passband (overlap-save FFT, or a blocked-Toeplitz
matmul with complex or real taps) → RSSI → demod → AGC → squelch →
resample (L× polyphase, or rational L/M) to the audio rate. State (NCO
phase, filter history, demod memory, AGC level, resampler tail, squelch
gate) is explicit and field for field the reference's, so a state moves
between the packages unchanged and consecutive chunks are sample-exact
continuous. The chain batches over any leading axes of the input.

Two back halves, chosen exactly as the reference does (`pallas_tail_ok`):
a 1-D batch of ≥ 128 receivers in AM/USB/LSB/CW/NBFM with an integer
upsample runs demod → resample as one kernel launch
(`ops/cuda/chain_tail.chain_tail_am_c`, `_process_tail_pallas`); anything
else runs the plain ops below, which is the reference's own XLA path. The
wideband time-major tiers call `process_tail_tmajor` with the channelizer's
raw planes or its time-major planes (`chain_tail_fir`, passband fused in),
or with a filtered passband (`chain_tail_am`).

What a configuration and its parameters fix is worked out once and held
(`utils/held.py`): the derived plans of a `ChainConfig`, the tail's tile,
FIR block (`tail_fir_block`) and scalars (`_tail_plan`), its parameter
vector and the squelch at the audio rate (rebuilt when a parameter tensor
changes). A chunk only launches work on its own data and state.

Under a running `torch.profiler` (`utils/profiling.span`),
`process_tail_tmajor` records its chunk as the span `chain.tail` with three
children: `chain.tail.pack` (the kernel's inputs: the state rows, the
history, the parameter vector), `chain.tail.launch` (the kernel's call) and
`chain.tail.unpack` (the RSSI in dB, the squelch, the state from the rows).
Every squelch gate, on any tail, runs in a span `chain.tail.squelch` of
its own (`profiling.device_span`: its device work marked in the stream):
on the time-major tails one `ops/cuda/squelch_gate` launch, in place, which
reads the state at the planar row order's bins and writes the new state
there; on the chain-major tails the plain gate (`_gate`). After it,
`profiling.count_gate` keeps what the gate met (the gains in, the gates
out, both in bin order) for `profiling.gates()` to count.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import NamedTuple

import numpy as np
import torch

from supersdr_tpu_torch.device import default_device
from supersdr_tpu_torch.ops import agc as agc_ops
from supersdr_tpu_torch.ops import cx
from supersdr_tpu_torch.ops import demod as demod_ops
from supersdr_tpu_torch.ops import (fir_matmul, firdesign, mixer,
                                    overlap_save, passband, resample)
from supersdr_tpu_torch.ops import smeter
from supersdr_tpu_torch.ops import squelch as squelch_ops
from supersdr_tpu_torch.ops.cuda import chain_tail, squelch_gate
from supersdr_tpu_torch.utils import held, profiling


@dataclass(frozen=True)
class ChainConfig:
    """Static chain structure; field names, order, defaults and checks as
    the reference's. The impl/precision strings name the reference's
    tiers: the plain matmul passbands and resamplers run in float32 at
    every precision, the fused tails round operands to bf16 where the
    reference's kernels do, and `passband_impl="fftmxu"` (the reference's
    one-row overlap-save through matrix-product DFTs) is the overlap-save
    passband with its one row a chunk, in float32 `torch.fft`. The plans
    below are worked out on first use and held by the (frozen) instance."""
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
    blanker_enabled: bool = False
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
        if self.passband_impl not in ("fft", "fftmxu", "matmul",
                                      "matmul_real"):
            raise ValueError("passband_impl must be 'fft', 'fftmxu', "
                             "'matmul' or 'matmul_real'")
        if self.passband_impl == "fftmxu" and self.chunk != self.os_block:
            raise ValueError("passband_impl='fftmxu' runs one overlap-save"
                             " row per chunk (os_block must equal chunk)")
        if self.audio_rate % self.iq_rate:
            _, M = self.resample_LM
            if self.chunk % M:
                raise ValueError(
                    f"rational resampling {self.iq_rate}->{self.audio_rate}"
                    f" needs chunk % {M} == 0 (got chunk={self.chunk})")

    @cached_property
    def os_plan(self) -> overlap_save.OSPlan:
        return overlap_save.plan_for(self.os_block, self.n_taps)

    @cached_property
    def fir_plan(self) -> fir_matmul.FIRMatmulPlan:
        return fir_matmul.plan_for(self.chunk, self.n_taps)

    @property
    def is_rational(self) -> bool:
        return self.audio_rate % self.iq_rate != 0

    @property
    def resample_LM(self) -> tuple[int, int]:
        g = int(np.gcd(self.iq_rate, self.audio_rate))
        return self.audio_rate // g, self.iq_rate // g

    @property
    def upsample(self) -> int:
        if self.is_rational:
            raise ValueError("non-integer rate ratio; use resample_LM")
        return self.audio_rate // self.iq_rate

    @property
    def audio_chunk(self) -> int:
        L, M = self.resample_LM
        return self.chunk * L // M

    @property
    def hang_window(self) -> int:
        if not self.hang_enabled:
            return 1
        return agc_ops.hang_samples(self.iq_rate, self.hang_ms)

    @cached_property
    def interp_plan(self) -> resample.InterpPlan:
        plan, _ = resample.design_interp(self.iq_rate, self.audio_rate)
        return plan

    @cached_property
    def interp_matmul_plan(self) -> resample.InterpMatmulPlan:
        return resample.plan_interp_matmul(self.interp_plan, self.chunk)

    @cached_property
    def rational_plan(self) -> resample.RationalPlan:
        plan, _ = resample.plan_rational(self.iq_rate, self.audio_rate)
        return plan


class ChainParams(NamedTuple):
    """Runtime tuning, the reference's fields in its order."""
    nco: mixer.NCOParams
    H_pass: cx.CX                      # [fft_size] passband response
    P_interp: torch.Tensor             # [per, L] polyphase matrix, or the
                                       # rational prototype [n_taps]
    agc: agc_ops.AGCParams
    squelch: squelch_ops.SquelchParams
    blanker: squelch_ops.BlankerParams
    W_pass: torch.Tensor | None = None    # matmul passband matrix
    rot_in: cx.CX | None = None           # matmul_real input rotation
    rot_out: cx.CX | None = None          # matmul_real output rotation
    W_interp: torch.Tensor | None = None  # matmul resampler matrix
    mode_id: torch.Tensor | None = None   # [*batch] per-slot demod (MULTI)
    W_tailpass: torch.Tensor | None = None  # in-tail passband: real
                                            # [W, B] or folded [2W, 2B]


class ChainState(NamedTuple):
    phase: torch.Tensor
    os_carry: cx.CX                   # [*batch, n_taps−1] input history
    demod: demod_ops.DemodState
    agc: agc_ops.AGCState
    interp_carry: torch.Tensor        # resampler tail
    squelch: squelch_ops.SquelchState


class ChainOutput(NamedTuple):
    audio: torch.Tensor               # [*batch, audio_chunk] (IQ: CX)
    rssi: torch.Tensor                # [*batch, chunk/os_block] dB
    baseband: cx.CX | None            # passband-filtered [*batch, chunk]


def _rotation(phase: np.ndarray, device) -> cx.CX:
    """e^{j·phase} as float32 planes (cos and sin in float64 first)."""
    return cx.CX(torch.from_numpy(np.cos(phase).astype(np.float32)).to(device),
                 torch.from_numpy(np.sin(phase).astype(np.float32)).to(device))


def make_params(cfg: ChainConfig,
                freq_offset_hz: float | np.ndarray = 0.0,
                delta_low: float = 0.0, delta_high: float = 0.0,
                low_cut: float | None = None,
                high_cut: float | None = None,
                agc_kwargs: dict | None = None,
                squelch_kwargs: dict | None = None,
                blanker_kwargs: dict | None = None,
                device=None) -> ChainParams:
    """Host-side build (float64 design, float32 tensors on `device`: the
    current CUDA device unless one is given, `device.default_device`).
    `freq_offset_hz` is the receiver's offset in the IQ span; passband
    defaults follow the mode unless explicit cuts are given."""
    device = default_device(device)
    if low_cut is None or high_cut is None:
        lc, hc = passband.supersdr_passband(cfg.mode, delta_low, delta_high)
    else:
        lc, hc = low_cut, high_cut
    taps = firdesign.complex_bandpass_taps(lc, hc, cfg.iq_rate, n=cfg.n_taps)
    W_interp = None
    if cfg.is_rational:
        # P_interp carries the rational resampler's prototype instead
        _, P = resample.plan_rational(cfg.iq_rate, cfg.audio_rate)
    else:
        itaps = firdesign.lowpass_taps(cfg.iq_rate / 2, cfg.audio_rate)
        _, P = resample.plan_interp(cfg.upsample, itaps)
        if cfg.resample_impl == "matmul":
            W_interp = resample.build_w_interp(cfg.interp_matmul_plan, itaps,
                                               device=device)
    W_pass, rot_in, rot_out = None, None, None
    if cfg.passband_impl == "matmul":
        W_pass = fir_matmul.build_w(cfg.fir_plan, taps, device=device)
    elif cfg.passband_impl == "matmul_real":
        # the real lowpass prototype on the rotated stream, ω snapped to
        # the fs/chunk grid so the rotations are chunk-periodic
        center, half_width = 0.5 * (lc + hc), 0.5 * (hc - lc)
        grid = cfg.iq_rate / cfg.chunk
        center_s = round(center / grid) * grid
        proto = firdesign.lowpass_taps_n(half_width, cfg.iq_rate, cfg.n_taps)
        W_pass = fir_matmul.build_w_real(cfg.fir_plan, proto, device=device)
        if center_s != 0.0:
            w = 2.0 * np.pi * center_s / cfg.iq_rate
            ns = np.arange(cfg.chunk)
            c = (cfg.n_taps - 1) / 2.0
            rot_in = _rotation(-w * ns, device)
            rot_out = _rotation(w * (ns - c), device)
    W_tailpass = None
    if cfg.passband_impl == "matmul" and not cfg.is_rational:
        bn = tail_fir_block(cfg)
        if bn is not None:
            w = (fir_matmul.build_w_free_real(*bn, taps)
                 if fir_matmul.taps_are_real(taps)
                 else fir_matmul.build_w_free(*bn, taps))
            W_tailpass = torch.from_numpy(w).to(device)
    return ChainParams(
        nco=mixer.NCOParams.make(-np.asarray(freq_offset_hz, np.float64),
                                 cfg.iq_rate, cfg.chunk, device=device),
        H_pass=overlap_save.taps_to_freq(cfg.os_plan, taps, device=device),
        P_interp=torch.from_numpy(np.asarray(P, np.float32)).to(device),
        agc=agc_ops.make_params(cfg.iq_rate, **(agc_kwargs or {}),
                                device=device),
        squelch=squelch_ops.make_squelch(**(squelch_kwargs or {}),
                                         device=device),
        blanker=squelch_ops.make_blanker(**(blanker_kwargs or {}),
                                         device=device),
        W_pass=W_pass, rot_in=rot_in, rot_out=rot_out, W_interp=W_interp,
        W_tailpass=W_tailpass)


def init_state(cfg: ChainConfig, batch_shape: tuple[int, ...] = (),
               device=None) -> ChainState:
    """Zero stream state on `device` (default: the current CUDA device)."""
    device = default_device(device)
    if cfg.is_rational:
        icarry = torch.zeros(batch_shape + (cfg.rational_plan.history,),
                             dtype=torch.float32, device=device)
    else:
        icarry = resample.init_carry(cfg.interp_plan, batch_shape,
                                     device=device)
    return ChainState(
        phase=mixer.init_phase(batch_shape, device=device),
        os_carry=overlap_save.init_carry(cfg.os_plan, batch_shape,
                                         device=device),
        demod=demod_ops.init_state(batch_shape, device=device),
        agc=agc_ops.init_state(batch_shape, device=device),
        interp_carry=icarry,
        squelch=squelch_ops.init_squelch(batch_shape, device=device))


@lru_cache(maxsize=64)
def _tail_tile(chunk: int, n_taps: int | None = None) -> int:
    """The reference's tail tile: a chunk divisor ≤ 1008, multiple of 8,
    with the smallest in-tail FIR block (ties to the larger tile). The
    plain tails scan in these tiles; the kernels keep the peak decay and
    the hang in segments of it."""
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


def tail_fir_block(cfg: ChainConfig) -> tuple | None:
    """The in-tail FIR block (B, n_prev) at the tail's tile
    (`fir_matmul.tail_fir_block`), or None where none fits: whether the
    FIR tail filters the passband itself (`make_params`' `W_tailpass`, the
    wideband's planar tier)."""
    return fir_matmul.tail_fir_block(cfg.chunk, cfg.n_taps,
                                     _tail_tile(cfg.chunk, cfg.n_taps))


def pallas_tail_ok(cfg: ChainConfig, batch: tuple) -> bool:
    """The reference's predicate for its fused tail (`_pallas_tail_ok`:
    the tier the port's tail kernels serve) on a batch of receivers."""
    return (cfg.mode.upper() in ("AM", "USB", "LSB", "CW", "NBFM")
            and not cfg.is_rational
            and cfg.agc_decimation == 1
            and len(batch) == 1 and batch[0] >= 128
            and _tail_tile(cfg.chunk, cfg.n_taps) >= 8)


def _tail_demod(cfg: ChainConfig) -> str:
    return {"AM": "am", "USB": "ssb", "LSB": "ssb", "CW": "ssb",
            "NBFM": "nbfm"}[cfg.mode.upper()]


def _tail_hang_window(cfg: ChainConfig) -> int:
    return cfg.hang_window if cfg.hang_enabled else 0


class _TailPlan(NamedTuple):
    """What the tail kernels take of a `ChainConfig`, besides tensors."""
    per: int                       # resampler taps a branch
    tile: int                      # `_tail_tile`
    fir_block: tuple | None        # in-tail FIR (B, n_prev), or None
    rb: int                        # resampler rows a block: 32, 16 or 0
    hang: int                      # AGC hang window, samples (0: off)
    demod: str
    slot0: float                   # the parameter vector's slot 0


@lru_cache(maxsize=64)
def _tail_plan(cfg: ChainConfig) -> _TailPlan:
    tile = _tail_tile(cfg.chunk, cfg.n_taps)
    return _TailPlan(
        per=cfg.interp_plan.per, tile=tile, fir_block=tail_fir_block(cfg),
        rb=32 if tile % 32 == 0 else (16 if tile % 16 == 0 else 0),
        hang=_tail_hang_window(cfg), demod=_tail_demod(cfg),
        slot0=(cfg.iq_rate / (2.0 * np.pi * cfg.max_dev_hz)
               if cfg.mode.upper() == "NBFM" else 0.999))


def _build_params_vec(decay, thresh, slope, target, man_gain, on, attack,
                      hang, slot0: float) -> torch.Tensor:
    # torch.full fills on the device: a host copy would wait for the card
    s0 = torch.full((), slot0, dtype=torch.float32, device=on.device)
    return torch.stack([s0, decay, thresh, slope, target, man_gain, on,
                        attack, hang]).to(torch.float32)


_PARAMS_VEC = held.FromTensors(_build_params_vec)


def _tail_params_vec(params: ChainParams, cfg: ChainConfig) -> torch.Tensor:
    """[9] float32: slot 0 is the AM DC pole or, for NBFM, the
    discriminator scale fs/(2π·max_dev); then the AGC scalars and the
    runtime hang flag. Built once for a set of AGC tensors and held."""
    ag = params.agc
    return _PARAMS_VEC((ag.decay_per_sample_db, ag.thresh_db, ag.slope_db,
                        ag.target_db, ag.man_gain_db, ag.on,
                        ag.attack_coeff, ag.hang), _tail_plan(cfg).slot0)


@lru_cache(maxsize=64)
def _zeros(shape: tuple, dtype: torch.dtype, device: torch.device
           ) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def _state_rows(cfg: ChainConfig, state: ChainState, order=None
                ) -> torch.Tensor:
    """The tail kernels' [4 + per, C] state rows (last row: power, 0),
    columns permuted by `order` when given."""
    nbfm = cfg.mode.upper() == "NBFM"
    r0 = state.demod.last_sample.re if nbfm else state.demod.dc_x
    r1 = state.demod.last_sample.im if nbfm else state.demod.dc_y
    rows = torch.cat([torch.stack([r0, r1, state.agc.peak_db,
                                   state.agc.gain_db]),
                      state.interp_carry.T,
                      _zeros((1, *r0.shape), r0.dtype, r0.device)])
    return (rows if order is None else rows[:, order]).contiguous()


def _unpack_rows(cfg: ChainConfig, state: ChainState, st2: torch.Tensor,
                 inv=None) -> tuple:
    """(demod, agc, interp_carry) state from the kernels' rows, columns
    permuted back by `inv` when given."""
    PER = cfg.interp_plan.per
    if inv is not None:
        st2 = st2[:, inv]
    o0, o1 = st2[0], st2[1]
    if cfg.mode.upper() == "NBFM":
        dstate = demod_ops.DemodState(last_sample=cx.CX(o0, o1),
                                      dc_x=state.demod.dc_x,
                                      dc_y=state.demod.dc_y)
    else:
        dstate = demod_ops.DemodState(last_sample=state.demod.last_sample,
                                      dc_x=o0, dc_y=o1)
    astate = agc_ops.AGCState(peak_db=st2[2], gain_db=st2[3])
    return dstate, astate, st2[4:4 + PER - 1].T.contiguous()


def _build_squelch_tail(enabled, thresh_db, hyst_db, ramp, upsample: int
                        ) -> squelch_ops.SquelchParams:
    return squelch_ops.SquelchParams(enabled, thresh_db, hyst_db,
                                     ramp / float(upsample))


_SQUELCH_TAIL = held.FromTensors(_build_squelch_tail)


def _squelch_tail(params: ChainParams, cfg: ChainConfig
                  ) -> squelch_ops.SquelchParams:
    """The squelch at the audio rate: the ramp rescaled so its duration
    in seconds matches the gate at the IQ rate (as the reference). Held
    for a set of squelch tensors."""
    return _SQUELCH_TAIL(tuple(params.squelch), cfg.upsample)


def _gate(params: squelch_ops.SquelchParams, state: squelch_ops.SquelchState,
          audio: torch.Tensor, rssi_db: torch.Tensor
          ) -> tuple[squelch_ops.SquelchState, torch.Tensor]:
    """The squelch gate on chain-major audio in its span, then kept for
    the gate counter."""
    with profiling.device_span("chain.tail.squelch", audio):
        gated, audio = squelch_ops.apply_squelch(params, state, audio,
                                                 rssi_db)
    profiling.count_gate(state.gain, gated.open_)
    return gated, audio


def _process_tail_pallas(cfg: ChainConfig, params: ChainParams,
                         state: ChainState, phase: torch.Tensor,
                         y: torch.Tensor, rssi: torch.Tensor,
                         os_carry: cx.CX) -> tuple[ChainState, ChainOutput]:
    """Fused back half on y [C, chunk] (complex64): one `chain_tail_am_c`
    launch reads y in place (no transpose) and writes audio [C,
    chunk·L]; then the squelch gate at the audio rate."""
    tp = _tail_plan(cfg)
    audio, st2 = chain_tail.chain_tail_am_c(
        y, _state_rows(cfg, state), _tail_params_vec(params, cfg),
        params.P_interp, tile_t=tp.tile, demod=tp.demod,
        hang_window=tp.hang)
    sq_state = state.squelch
    if cfg.squelch_enabled:
        sq_state, audio = _gate(_squelch_tail(params, cfg), state.squelch,
                                audio, torch.mean(rssi, dim=-1))
    dstate, astate, icarry = _unpack_rows(cfg, state, st2)
    new_state = ChainState(phase=phase, os_carry=os_carry, demod=dstate,
                           agc=astate, interp_carry=icarry,
                           squelch=sq_state)
    return new_state, ChainOutput(audio=audio, rssi=rssi,
                                  baseband=cx.CX(y.real, y.imag))


def process_tail_tmajor(cfg: ChainConfig, params: ChainParams,
                        state: ChainState, phase: torch.Tensor,
                        os_carry: cx.CX, *, yT: cx.CX | None = None,
                        fir_x: cx.CX | None = None,
                        fir_x3: tuple | None = None,
                        chan_order: torch.Tensor | None = None,
                        chan_inv: torch.Tensor | None = None,
                        audio_dtype: torch.dtype = torch.float32
                        ) -> tuple[ChainState, torch.Tensor, torch.Tensor]:
    """Time-major fused back half, one kernel launch, on one of three
    sources (the reference's):

    fir_x3  (raw_r, raw_i) [n1, chunk, n2], the channelizer's raw planes:
            the FIR tail filters them in place; audio and RSSI rows come
            out in planar channel order: `chan_order` (row → bin, an index
            tensor on the planes' device) permutes the bin-ordered
            ChainState in, and `chan_inv` (its inverse, which the caller
            holds with it) back out;
    fir_x   CX [chunk, C], the channelizer's time-major bin-ordered
            planes: the same FIR tail, which reads them as one plane of
            C columns;
    yT      CX [chunk, C], an already filtered passband: the non-FIR
            tail, with its power row.

    `os_carry` is the new input history (bin order) for the next chunk.
    The squelch gates the audio from the in-kernel RSSI. Returns (state,
    audioT [chunk·L, C], rssi [C, 1])."""
    with profiling.span("chain.tail"):
        if cfg.chunk != cfg.os_block:
            raise ValueError("time-major tail needs os_block == chunk")
        if (yT is not None) + (fir_x is not None) + (fir_x3 is not None) != 1:
            raise ValueError("give exactly one of yT, fir_x and fir_x3")
        order = inv = None
        with profiling.span("chain.tail.pack"):
            if fir_x3 is not None:
                if chan_order is None or chan_inv is None:
                    raise ValueError("fir_x3 needs chan_order and chan_inv")
                order, inv = chan_order, chan_inv
            tp = _tail_plan(cfg)
            pvec = _tail_params_vec(params, cfg)
            if yT is not None:
                rows = _state_rows(cfg, state)
            else:
                if params.W_tailpass is None:
                    raise ValueError("params.W_tailpass missing "
                                     "(passband_impl must be 'matmul' "
                                     "with a fusable FIR block)")
                raw_r, raw_i = fir_x3 if fir_x3 is not None \
                    else (fir_x.re[None], fir_x.im[None])
                hist_r, hist_i = state.os_carry.re, state.os_carry.im
                if order is not None:
                    hist_r, hist_i = hist_r[order], hist_i[order]
                B, n_prev = tp.fir_block
                hist_r, hist_i = hist_r.T.contiguous(), hist_i.T.contiguous()
                rows = _state_rows(cfg, state, order)
        with profiling.span("chain.tail.launch"):
            if yT is not None:
                audioT, st2 = chain_tail.chain_tail_am(
                    yT.re, yT.im, rows, pvec, params.P_interp,
                    tile_t=tp.tile, demod=tp.demod, accum_pow=True,
                    hang_window=tp.hang, audio_layout="time")
            else:
                audioT, st2 = chain_tail.chain_tail_fir(
                    raw_r, raw_i, hist_r, hist_i, rows, pvec,
                    params.W_tailpass, params.P_interp, n_taps=cfg.n_taps, B=B,
                    n_prev=n_prev, tile_t=tp.tile, demod=tp.demod,
                    fir_bf16=cfg.passband_precision == "default",
                    rs_bf16=(cfg.resample_impl == "matmul" and tp.rb != 0
                             and cfg.resample_precision == "default"),
                    hang_window=tp.hang)
        with profiling.span("chain.tail.unpack"):
            if audio_dtype != torch.float32:
                audioT = audioT.to(audio_dtype)
            pw = st2[4 + tp.per - 1] / cfg.chunk
            rssi = torch.clamp_min(
                10.0 * torch.log10(torch.clamp_min(pw, 1e-30))
                + smeter.DEFAULT_CAL_DB, smeter.RSSI_FLOOR_DB)[:, None]
            sq_state = state.squelch
            if cfg.squelch_enabled:
                with profiling.device_span("chain.tail.squelch", audioT):
                    sq_state, audioT = squelch_gate.squelch_gate_tmajor(
                        _squelch_tail(params, cfg), state.squelch, audioT,
                        rssi[:, 0], order)
                profiling.count_gate(state.squelch.gain, sq_state.open_)
            dstate, astate, icarry = _unpack_rows(cfg, state, st2, inv)
        new_state = ChainState(phase=phase, os_carry=os_carry, demod=dstate,
                               agc=astate, interp_carry=icarry,
                               squelch=sq_state)
        return new_state, audioT, rssi


def process_traced(cfg: ChainConfig, params: ChainParams, state: ChainState,
                   iq) -> tuple[ChainState, ChainOutput]:
    """One chunk through the chain: iq [*batch, chunk] as a CX on the
    params' device, or a complex64 tensor there (the wideband tier hands
    its channels over as they are)."""
    iqc = iq if isinstance(iq, torch.Tensor) \
        else torch.complex(iq.re, iq.im)
    plan = cfg.os_plan
    batch = tuple(iqc.shape[:-1])
    n_rows = cfg.chunk // cfg.os_block
    if cfg.blanker_enabled:
        iqc = squelch_ops.apply_blanker(params.blanker, iqc)
    if cfg.nco_enabled:
        phase, x = mixer.mix(params.nco, state.phase, iqc)
    else:
        phase, x = state.phase, iqc
    # passband: batched overlap-save rows, or the blocked-Toeplitz matmul
    # (the same carried input history either way). "fftmxu" runs one row a
    # chunk (os_block == chunk): history ‖ chunk zero-padded to fft_size,
    # times H_pass, transformed back, the overlap sliced off — the
    # overlap-save branch with one row, its DFTs in float32 torch.fft
    if cfg.passband_impl == "matmul":
        _, yc = fir_matmul.fir_matmul_stream_c(
            cfg.fir_plan, params.W_pass, state.os_carry,
            cx.CX(x.real, x.imag))
        y = torch.complex(yc.re, yc.im)
    elif cfg.passband_impl == "matmul_real":
        xs, carry = x, torch.complex(state.os_carry.re, state.os_carry.im)
        if params.rot_in is not None:
            rin = torch.complex(params.rot_in.re, params.rot_in.im)
            xs = xs * rin
            if plan.overlap:
                carry = carry * rin[..., -plan.overlap:]
        _, u = fir_matmul.fir_matmul_stream_real_c(
            cfg.fir_plan, params.W_pass, cx.CX(carry.real, carry.imag),
            cx.CX(xs.real, xs.imag))
        y = torch.complex(u.re, u.im)
        if params.rot_out is not None:
            y = y * torch.complex(params.rot_out.re, params.rot_out.im)
    else:
        H = torch.complex(params.H_pass.re, params.H_pass.im)
        if H.ndim > 1:
            H = H[..., None, :]      # per-slot responses over the rows
        y = overlap_save.overlap_save_batch_c(
            plan, H, torch.complex(state.os_carry.re, state.os_carry.im),
            x.reshape(*batch, n_rows, cfg.os_block)
        ).reshape(*batch, cfg.chunk)
    y_rows = y.reshape(*batch, n_rows, cfg.os_block)
    tail = x[..., -plan.overlap:] if plan.overlap else x[..., :0]
    os_carry = cx.CX(tail.real.contiguous(), tail.imag.contiguous())
    rssi = smeter.rssi_db(y_rows)

    if cfg.tail_impl == "pallas" and pallas_tail_ok(cfg, batch):
        return _process_tail_pallas(cfg, params, state, phase, y, rssi,
                                    os_carry)

    if cfg.mode.upper() == "MULTI":
        dstate, audio = demod_ops.demodulate_runtime(
            state.demod, y, cfg.iq_rate, params.mode_id, cfg.max_dev_hz)
    else:
        dstate, audio = demod_ops.demodulate(cfg.mode, state.demod, y,
                                             cfg.iq_rate,
                                             max_dev_hz=cfg.max_dev_hz)
    astate, audio = agc_ops.apply(params.agc, state.agc, audio,
                                  hang_window=cfg.hang_window,
                                  decimation=cfg.agc_decimation)
    sq_state = state.squelch
    if cfg.squelch_enabled:
        sq_state, audio = _gate(params.squelch, state.squelch, audio,
                                torch.mean(rssi, dim=-1))
    if cfg.mode.upper() == "IQ":
        out_audio = cx.CX(audio.real, audio.imag)
        icarry = state.interp_carry
    elif cfg.is_rational:
        icarry, out_audio = resample.rational_resample_block(
            cfg.rational_plan, params.P_interp, state.interp_carry,
            audio.float())
    elif cfg.resample_impl == "matmul":
        icarry, out_audio = resample.interpolate_matmul(
            cfg.interp_matmul_plan, params.W_interp, state.interp_carry,
            audio.float())
    else:
        icarry, out_audio = resample.interpolate(
            cfg.interp_plan, params.P_interp, state.interp_carry,
            audio.float(), cfg.resample_impl)
    new_state = ChainState(phase=phase, os_carry=os_carry, demod=dstate,
                           agc=astate, interp_carry=icarry,
                           squelch=sq_state)
    return new_state, ChainOutput(audio=out_audio, rssi=rssi,
                                  baseband=cx.CX(y.real, y.imag))


def process(cfg: ChainConfig, params: ChainParams, state: ChainState,
            iq) -> tuple[ChainState, ChainOutput]:
    """One chunk: iq [*batch, chunk] as a CX, complex numpy or complex
    tensor, moved to the params' device."""
    return process_traced(cfg, params, state,
                          cx.as_cx(iq, device=params.P_interp.device))


def run_offline(cfg: ChainConfig, params: ChainParams, iq: np.ndarray,
                state: ChainState | None = None
                ) -> tuple[ChainState, np.ndarray, np.ndarray]:
    """Stream a whole IQ signal [*batch, n] through the chain in `cfg.chunk`
    slices (the tail zero-padded); returns (final state, audio, rssi rows)
    with numpy outputs (complex audio in IQ mode)."""
    dev = params.P_interp.device
    if state is None:
        state = init_state(cfg, iq.shape[:-1], device=dev)
    n = iq.shape[-1]
    pad = (-n) % cfg.chunk
    iqp = np.pad(np.asarray(iq, np.complex64),
                 [(0, 0)] * (iq.ndim - 1) + [(0, pad)])
    audio_parts, rssi_parts = [], []
    for i in range(0, iqp.shape[-1], cfg.chunk):
        state, out = process(cfg, params, state, iqp[..., i:i + cfg.chunk])
        a = out.audio
        audio_parts.append(
            torch.complex(a.re, a.im).cpu().numpy() if isinstance(a, cx.CX)
            else a.cpu().numpy())
        rssi_parts.append(out.rssi.cpu().numpy())
    audio = np.concatenate(audio_parts, axis=-1)
    rssi = np.concatenate(rssi_parts, axis=-1)
    if cfg.mode.upper() != "IQ":
        L, M = cfg.resample_LM
        audio = audio[..., : n * L // M]
    return state, audio, rssi
