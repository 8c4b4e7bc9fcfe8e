"""Wideband receiver: one capture → polyphase channelizer → N demod chains.

Counterpart of `supersdr_tpu/runtime/wideband.py`. Its tiers, chosen by
the reference's own predicates:

  planar      (`time_major`, `_planar_active`): the fused channelizer's raw
              [n1, frames, n2] planes feed the FIR-fused chain tail
              directly; audio comes back time-major [frames·L, n_chan]
              with rows in planar channel order;
  time-major  (`time_major`, `_tmajor_fused_ok` but not `_planar_active`:
              a frame count that `chan_tile_t` does not divide, as the
              CLI's file chunks, or a passband too short for the in-tail
              FIR block): the fused channelizer writes time-major
              bin-ordered planes [frames, n_chan]; the FIR tail filters
              them, or the time-major Toeplitz product does and the
              non-FIR tail follows; audio [frames·L, n_chan] in bin order;
  chan-major  (`time_major=False`, the default): `channelize_dispatch`
              (the fold kernel with `pallas_fold`, the fused channelizer
              permuted to bin order, or the plain fold + FFT) → the
              receiver chain batched over the channels (`chain.process`,
              whose ≥ 128-channel tail is one kernel launch); audio
              [n_chan, frames·L];
  fallback    (`time_major` but `_tmajor_fused_ok` false: SMALL's 16
              channels, `--n-chan 100`, odd chunks): the chan-major
              pipeline plus one transpose.

`audio_channel_order` maps rows to PFB bins (identity off the planar
tier) and `channel_freqs` is row-aligned. The state is the same on every
tier, so a stream may change tier between chunks.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from supersdr_tpu_torch.device import default_device
from supersdr_tpu_torch.ops import channelizer, cx, fir_matmul
from supersdr_tpu_torch.ops.cuda import channelize_fused, pfb_fold
from supersdr_tpu_torch.runtime import chain

# The reference's two tuned tiers, by the same names and values; both run
# the planar path. "fast": bf16 stage-B operands and bf16 raw planes, bf16
# passband operands. "quality": float32 throughout. The resampler is
# float32 in both.
PROFILES = {
    "fast": dict(passband_impl="matmul", passband_precision="default",
                 chan_impl="mxu2fused", chan_precision="default",
                 resample_impl="matmul",
                 resample_precision="high", tail_impl="pallas",
                 time_major=True),
    "quality": dict(passband_impl="matmul", passband_precision="high",
                    chan_impl="mxu2fused", chan_precision="high",
                    resample_impl="matmul",
                    resample_precision="high", tail_impl="pallas",
                    time_major=True, chan_tile_t=64),
}

_AUDIO_DTYPES = {"f32": torch.float32, "f16": torch.float16,
                 "bf16": torch.bfloat16}
_CHAN_IMPLS = ("legacy", "mxu2", "mxu2fused")
_CHAN_IMPLS_NOT_PORTED = ("mxu2conv", "mxu2pallas", "stub", "nofft")


@dataclass(frozen=True)
class WidebandConfig:
    """fs_in must equal n_chan·chain.iq_rate (critical sampling). Field
    names, order, defaults and checks follow the reference's, so one
    keyword set builds both, less four TPU A/B knobs that are not ported
    (mxu_chan_fft, chan_fold_dtype, chan_fft_form, chan_split2: the port
    runs stage B unsplit). `pallas_fold` routes the chan-major
    channelizer through the fold kernel (`ops/cuda/pfb_fold.py`); the
    `chan_impl` values mxu2conv, mxu2pallas, stub and nofft are accepted
    but raise at `process` (the reference's superseded variants)."""
    fs_in: int = 1_200_000
    n_chan: int = 100
    taps_per: int = 8
    mode: str = "AM"
    chunk_in: int = 1_200_000 // 4
    audio_rate: int = 48000
    n_taps: int = 257
    agc_decimation: int = 1
    hang_enabled: bool = False
    hang_ms: float = 500.0
    squelch_enabled: bool = False
    max_dev_hz: float = 5000.0
    pallas_fold: bool = False
    passband_impl: str = "fft"
    passband_precision: str = "highest"
    resample_impl: str = "einsum"
    resample_precision: str = "highest"
    chan_impl: str = "legacy"
    chan_precision: str = "highest"
    tail_impl: str = "xla"
    time_major: bool = False
    chan_tile_t: int = 128
    chan_factors: tuple | None = None
    audio_dtype: str = "f32"

    def __post_init__(self):
        if self.fs_in % self.n_chan:
            raise ValueError("n_chan must divide fs_in")
        if self.chunk_in % self.n_chan:
            raise ValueError("chunk_in must be a multiple of n_chan")
        if self.time_major and self.mode.upper() == "IQ":
            raise ValueError("time_major is an audio-path layout (IQ "
                             "mode keeps complex baseband)")
        if self.audio_dtype not in _AUDIO_DTYPES:
            raise ValueError("audio_dtype must be 'f32', 'f16' or 'bf16'")
        if self.chan_factors is not None:
            n1f, n2f = self.chan_factors
            if n1f * n2f != self.n_chan or n2f % 128:
                raise ValueError("chan_factors must multiply to n_chan "
                                 "with a lane-multiple n2")
        if self.chan_impl not in _CHAN_IMPLS + _CHAN_IMPLS_NOT_PORTED:
            raise ValueError(f"chan_impl must be one of "
                             f"{_CHAN_IMPLS + _CHAN_IMPLS_NOT_PORTED}")

    @property
    def iq_rate(self) -> int:
        return self.fs_in // self.n_chan

    @property
    def chunk_per_chan(self) -> int:
        return self.chunk_in // self.n_chan

    @property
    def chain_cfg(self) -> chain.ChainConfig:
        # PFB outputs are channel-centred: the NCO pass is compiled out
        return chain.ChainConfig(mode=self.mode, iq_rate=self.iq_rate,
                                 audio_rate=self.audio_rate,
                                 chunk=self.chunk_per_chan,
                                 os_block=self.chunk_per_chan,
                                 n_taps=self.n_taps,
                                 agc_decimation=self.agc_decimation,
                                 hang_enabled=self.hang_enabled,
                                 hang_ms=self.hang_ms,
                                 squelch_enabled=self.squelch_enabled,
                                 max_dev_hz=self.max_dev_hz,
                                 nco_enabled=False,
                                 passband_impl=self.passband_impl,
                                 passband_precision=self.passband_precision,
                                 resample_impl=self.resample_impl,
                                 resample_precision=self.resample_precision,
                                 tail_impl=self.tail_impl)


class WidebandParams(NamedTuple):
    W_pfb: torch.Tensor
    chain: chain.ChainParams


class WidebandState(NamedTuple):
    pfb_carry: cx.CX           # [(taps_per−1)·n_chan] PFB input history
    chain: chain.ChainState


def make_params(cfg: WidebandConfig, device=None,
                **chain_kwargs) -> WidebandParams:
    """The PFB weights and the chain's parameters. The channels are
    centred already and the chain's NCO is compiled out, so its (unused)
    tuning is built for offset 0 alone, not one row per channel. On
    `device`: the current CUDA device unless one is given."""
    device = default_device(device)
    plan, proto = channelizer.design(cfg.n_chan, cfg.taps_per)
    return WidebandParams(
        W_pfb=channelizer.taps_matrix(plan, proto, device=device),
        chain=chain.make_params(cfg.chain_cfg, device=device,
                                **chain_kwargs))


def init_state(cfg: WidebandConfig, device=None) -> WidebandState:
    """Zero stream state on `device` (default: the current CUDA device)."""
    device = default_device(device)
    return WidebandState(
        pfb_carry=channelizer.init_carry(pfb_plan(cfg), device=device),
        chain=chain.init_state(cfg.chain_cfg, (cfg.n_chan,), device=device))


def pfb_plan(cfg: WidebandConfig) -> channelizer.PFBPlan:
    return channelizer.PFBPlan(n_chan=cfg.n_chan, taps_per=cfg.taps_per,
                               hop=cfg.n_chan)


def _tmajor_fused_ok(cfg: WidebandConfig) -> bool:
    """The reference's predicate for its time-major fused tiers: the fused
    channelizer and tail serve the config, and either the in-tail FIR
    block or the standalone time-major FIR (chunk % block == 0) exists."""
    fac = channelizer._pick_factors(cfg.n_chan)
    ccfg = cfg.chain_cfg
    if not (cfg.chan_impl == "mxu2fused" and fac is not None
            and fac[1] % 128 == 0
            and cfg.chunk_per_chan % 8 == 0
            and ccfg.passband_impl == "matmul"
            and ccfg.tail_impl == "pallas"
            and chain._pallas_tail_ok(ccfg, (cfg.n_chan,))):
        return False
    if fir_matmul.tail_fir_block(
            ccfg.chunk, ccfg.n_taps,
            chain._tail_tile(ccfg.chunk, ccfg.n_taps)) is not None:
        return True
    return ccfg.chunk % ccfg.fir_plan.block == 0


def _planar_active(cfg: WidebandConfig) -> bool:
    """True when the reference runs this config on its planar tier."""
    if not (cfg.time_major and _tmajor_fused_ok(cfg)):
        return False
    fac = _factors_for(cfg)
    if fac is None or fac[1] % 128:
        return False
    if cfg.chunk_per_chan % cfg.chan_tile_t:
        return False
    ccfg = cfg.chain_cfg
    return fir_matmul.tail_fir_block(
        ccfg.chunk, ccfg.n_taps,
        chain._tail_tile(ccfg.chunk, ccfg.n_taps)) is not None


def _factors_for(cfg: WidebandConfig) -> tuple[int, int] | None:
    """The DIF factoring (n1, n2): `chan_factors` when given, else the
    default tree. The reference's quality tier picks a min-n1 tree to pair
    with its stage-B split; without the split that tree only makes stage B
    larger, so the port keeps the default tree in both tiers."""
    if cfg.chan_factors is not None:
        return tuple(cfg.chan_factors)
    return channelizer._pick_factors(cfg.n_chan)


def _split_levels_for(cfg: WidebandConfig, n2: int) -> int:
    """Stage-B split depth: 0 in both tiers. The reference splits stage B
    into radix-2 levels to halve TPU MXU work; the port's kernel runs the
    DFT unsplit, so raw columns are in k2 order."""
    return 0


def audio_channel_order(cfg: WidebandConfig) -> np.ndarray:
    """order[i] = PFB bin of audio/RSSI row i: row c = k1·n2 + k2 holds
    bin k2·n1 + k1 on the planar tier (identity elsewhere)."""
    if not _planar_active(cfg):
        return np.arange(cfg.n_chan)
    n1, n2 = _factors_for(cfg)
    colmap = channelizer.stageb_col_to_k2(n2, _split_levels_for(cfg, n2))
    c = np.arange(cfg.n_chan)
    return colmap[c % n2] * n1 + c // n2


def channel_freqs(cfg: WidebandConfig, center_hz: float = 0.0,
                  order: np.ndarray | None = None) -> np.ndarray:
    """Centre frequency of each output row given the capture centre."""
    freqs = center_hz + channelizer.channel_center_freqs(pfb_plan(cfg),
                                                         cfg.fs_in)
    if order is None:
        order = audio_channel_order(cfg)
    return freqs[np.asarray(order)]


@lru_cache(maxsize=16)
def _row_order(cfg: WidebandConfig, device: torch.device) -> torch.Tensor:
    """`audio_channel_order` as an index tensor on `device`, made once: a
    copy from host memory every chunk would wait for the card."""
    return torch.as_tensor(audio_channel_order(cfg), device=device)


def _is_i16_pair(iq) -> bool:
    """True for a plain (re_i16, im_i16) pair; a plain pair of any other
    dtype raises (wrap float planes as cx.CX)."""
    if not (isinstance(iq, tuple) and not isinstance(iq, cx.CX)
            and len(iq) == 2):
        return False
    dt = iq[0].dtype
    if not (dt == torch.int16 if isinstance(dt, torch.dtype)
            else np.dtype(dt) == np.int16):
        raise TypeError(f"plain 2-tuple IQ must be (re_i16, im_i16) int16 "
                        f"planes, got dtype {dt}; wrap float planes as "
                        f"cx.CX(re, im)")
    return True


def _coerce(iq, device):
    if _is_i16_pair(iq):
        return tuple(torch.as_tensor(p).to(device).contiguous() for p in iq)
    return cx.as_cx(iq, device=device)


def _as_f32_cx(iq) -> cx.CX:
    """CX as it is; an int16 pair dequantized (±32768 ≡ ±1.0)."""
    if isinstance(iq, cx.CX):
        return iq
    return cx.CX(iq[0].float() * (1.0 / 32768.0),
                 iq[1].float() * (1.0 / 32768.0))


def _check_ported(cfg: WidebandConfig) -> None:
    if cfg.chan_impl in _CHAN_IMPLS_NOT_PORTED:
        raise NotImplementedError(
            f"chan_impl={cfg.chan_impl!r} is one of the reference's "
            "superseded TPU variants, not ported (ROADMAP queue 1, "
            "do-not-port list)")


def channelize_dispatch(cfg: WidebandConfig, params: WidebandParams,
                        carry: cx.CX, iq: cx.CX
                        ) -> tuple[cx.CX, torch.Tensor]:
    """The chan-major channelizer, as the reference dispatches it:
    `pallas_fold` → the fold kernel + `torch.fft`; "mxu2fused" on a
    lane-aligned factoring and 8-aligned frames → the fused channelizer
    kernel, its planes permuted to bin order (the reference's
    out_layout="chan"); "mxu2fused" otherwise and "mxu2" →
    `channelize_mxu2_c`; "legacy" → `channelize_c`.

    carry: CX [history]; iq: CX [n] float32 planes. Returns (new carry CX,
    chans complex64 [n_chan, n/n_chan]). With a leading shard axis, carry
    [D, history] and iq [D, n] (each time shard with its own history: the
    sharded pipeline's fallback tier), each shard's new carry and chans
    [D, n_chan, n/n_chan], one launch for all shards."""
    _check_ported(cfg)
    plan = pfb_plan(cfg)
    M, K = cfg.n_chan, cfg.taps_per
    nf = iq.re.shape[-1] // M
    if cfg.pallas_fold:
        G = params.W_pfb.reshape(-1).flip(0).reshape(K, M).contiguous()
        return pfb_fold.channelize_pallas_c(plan, G, carry, iq)
    fac = channelizer._pick_factors(M)
    if cfg.chan_impl == "mxu2fused" and fac is not None \
            and fac[1] % 128 == 0 and nf % 8 == 0:
        n1, n2 = fac
        new_carry, (raw_r, raw_i) = channelize_fused.channelize_fused_raw3(
            plan, params.W_pfb, carry, iq, factors=fac,
            bf16_mxu=cfg.chan_precision == "default",
            out_dtype=torch.float32)
        # [n1(k1), nf, n2(k2)] → bin m = k2·n1 + k1: [n2, n1, nf] → [M, nf]
        lead = raw_r.shape[:-3]
        return new_carry, torch.complex(
            raw_r.movedim(-1, -3).reshape(*lead, M, nf),
            raw_i.movedim(-1, -3).reshape(*lead, M, nf))
    carry_c = torch.complex(carry.re, carry.im)
    x = torch.complex(iq.re, iq.im)
    if cfg.chan_impl in ("mxu2fused", "mxu2") and x.ndim == 1:
        c, chans = channelizer.channelize_mxu2_c(plan, params.W_pfb,
                                                 carry_c, x)
    else:
        c, chans = channelizer.channelize_c(plan, params.W_pfb, carry_c, x)
    return cx.CX(c.real.contiguous(), c.imag.contiguous()), chans


def _process_chan_major(cfg: WidebandConfig, params: WidebandParams,
                        state: WidebandState, iq
                        ) -> tuple[WidebandState, chain.ChainOutput]:
    pfb_carry, chans = channelize_dispatch(cfg, params, state.pfb_carry,
                                           _as_f32_cx(iq))
    cstate, out = chain.process_traced(cfg.chain_cfg, params.chain,
                                       state.chain, chans)
    return WidebandState(pfb_carry=pfb_carry, chain=cstate), out


def _process_planar(cfg: WidebandConfig, params: WidebandParams,
                    state: WidebandState, iq
                    ) -> tuple[WidebandState, chain.ChainOutput]:
    ccfg = cfg.chain_cfg
    n1, n2 = _factors_for(cfg)
    raw_dtype = (torch.bfloat16 if cfg.chan_precision == "default"
                 and cfg.passband_precision == "default" else torch.float32)
    pfb_carry, (raw_r, raw_i) = channelize_fused.channelize_fused_raw3(
        pfb_plan(cfg), params.W_pfb, state.pfb_carry, iq, factors=(n1, n2),
        bf16_mxu=cfg.chan_precision == "default", out_dtype=raw_dtype)
    # next chunk's FIR history: the raw tail [n1, ov, n2] → [n2, n1, ov]
    # → [M, ov]; row col·n1 + k1 is bin k2·n1 + k1 (col = k2, unsplit)
    ov = ccfg.n_taps - 1
    os_carry = cx.CX(
        raw_r[:, -ov:, :].permute(2, 0, 1).reshape(cfg.n_chan, ov).float(),
        raw_i[:, -ov:, :].permute(2, 0, 1).reshape(cfg.n_chan, ov).float())
    cstate, audioT, rssi = chain.process_tail_tmajor(
        ccfg, params.chain, state.chain, state.chain.phase, os_carry,
        fir_x3=(raw_r, raw_i), chan_order=_row_order(cfg, raw_r.device),
        audio_dtype=_AUDIO_DTYPES[cfg.audio_dtype])
    return (WidebandState(pfb_carry=pfb_carry, chain=cstate),
            chain.ChainOutput(audio=audioT, rssi=rssi, baseband=None))


def _process_tmajor_fused(cfg: WidebandConfig, params: WidebandParams,
                          state: WidebandState, iq
                          ) -> tuple[WidebandState, chain.ChainOutput]:
    """The time-major tier off the planar coupling: the channelizer kernel
    writes bin-ordered planes [nf, M] (an int16 pair goes to it as it is
    and is dequantized in the kernel); with an in-tail FIR block the FIR
    tail reads them (no baseband output), else the time-major Toeplitz
    passband runs alone and the non-FIR tail takes its yT."""
    ccfg = cfg.chain_cfg
    pfb_carry, chansT = channelize_fused.channelize_fused_c(
        pfb_plan(cfg), params.W_pfb, state.pfb_carry, iq,
        factors=channelizer._pick_factors(cfg.n_chan),
        bf16_mxu=cfg.chan_precision == "default", out_layout="time")
    chansT = cx.CX(*chansT)
    ov = ccfg.n_taps - 1
    os_carry = cx.CX(chansT.re[-ov:].T.contiguous(),
                     chansT.im[-ov:].T.contiguous())
    kw = dict(audio_dtype=_AUDIO_DTYPES[cfg.audio_dtype])
    if params.chain.W_tailpass is not None:
        yT = None
        kw["fir_x"] = chansT
    else:
        carry_T = cx.CX(state.chain.os_carry.re.T, state.chain.os_carry.im.T)
        _, yT = fir_matmul.fir_matmul_stream_tmajor_c(
            ccfg.fir_plan, params.chain.W_pass, carry_T, chansT)
        kw["yT"] = yT
    cstate, audioT, rssi = chain.process_tail_tmajor(
        ccfg, params.chain, state.chain, state.chain.phase, os_carry, **kw)
    return (WidebandState(pfb_carry=pfb_carry, chain=cstate),
            chain.ChainOutput(audio=audioT, rssi=rssi, baseband=yT))


def _process_tmajor(cfg: WidebandConfig, params: WidebandParams,
                    state: WidebandState, iq
                    ) -> tuple[WidebandState, chain.ChainOutput]:
    if _planar_active(cfg):
        return _process_planar(cfg, params, state, iq)
    if _tmajor_fused_ok(cfg):
        return _process_tmajor_fused(cfg, params, state, iq)
    # fallback: the chan-major pipeline plus one transpose
    st, out = _process_chan_major(cfg, params, state, iq)
    audioT = out.audio.T.to(_AUDIO_DTYPES[cfg.audio_dtype]).contiguous()
    bb = cx.CX(out.baseband.re.T, out.baseband.im.T)
    return st, chain.ChainOutput(audio=audioT, rssi=out.rssi, baseband=bb)


def process(cfg: WidebandConfig, params: WidebandParams,
            state: WidebandState, iq
            ) -> tuple[WidebandState, chain.ChainOutput]:
    """One chunk: iq [chunk_in] as a CX, complex numpy or complex tensor,
    or an (re_i16, im_i16) pair → audio [n_chan, chunk_per_chan·L]
    (`time_major`: [chunk_per_chan·L, n_chan], rows in
    `audio_channel_order`) and RSSI [n_chan, rows]. Inputs move to the
    params' device."""
    iq = _coerce(iq, params.W_pfb.device)
    if cfg.time_major:
        return _process_tmajor(cfg, params, state, iq)
    return _process_chan_major(cfg, params, state, iq)


def process_n(cfg: WidebandConfig, params: WidebandParams,
              state: WidebandState, iqs) -> tuple[WidebandState, tuple]:
    """N consecutive chunks (each a CX, complex array or int16 pair),
    state threaded through; audio returned as a tuple."""
    outs = []
    for iq in iqs:
        state, out = process(cfg, params, state, iq)
        outs.append(out.audio)
    return state, tuple(outs)


def process_many(cfg: WidebandConfig, params: WidebandParams,
                 state: WidebandState, iq_chunks
                 ) -> tuple[WidebandState, torch.Tensor | cx.CX]:
    """iq_chunks [n_chunks, chunk_in] (CX or complex) → (state, audio
    [n_chunks, …]) — IQ mode: a CX of stacked baseband planes."""
    chunks = cx.as_cx(iq_chunks, device=params.W_pfb.device)
    state, outs = process_n(cfg, params, state,
                            [cx.CX(chunks.re[i], chunks.im[i])
                             for i in range(chunks.re.shape[0])])
    if isinstance(outs[0], cx.CX):
        return state, cx.CX(torch.stack([o.re for o in outs]),
                            torch.stack([o.im for o in outs]))
    return state, torch.stack(outs)


def process_i16(cfg: WidebandConfig, params: WidebandParams,
                state: WidebandState, iq16
                ) -> tuple[WidebandState, chain.ChainOutput]:
    """One chunk of int16 IQ planes (re_i16, im_i16), full scale ±32768 ≡
    ±1.0; the planar channelizer dequantizes on load, the other tiers up
    front."""
    if not (isinstance(iq16, tuple) and len(iq16) == 2):
        raise TypeError("iq16 must be an (re_i16, im_i16) pair")
    return process(cfg, params, state, (iq16[0], iq16[1]))
