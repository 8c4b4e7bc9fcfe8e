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
              (every `chan_impl` the reference routes: the fold kernel
              with `pallas_fold` or "mxu2pallas", the fused channelizer
              permuted to bin order, the slice or convolution fold +
              FFT, the knockouts) → the receiver chain batched over the
              channels (`chain.process`, whose ≥ 128-channel tail is one
              kernel launch); audio [n_chan, frames·L];
  fallback    (`time_major` but `_tmajor_fused_ok` false: SMALL's 16
              channels, `--n-chan 100`, odd chunks): the chan-major
              pipeline plus one transpose.

`audio_channel_order` maps rows to PFB bins (identity off the planar
tier; the planar order is `channelize_fused.planar_order`) and
`channel_freqs` is row-aligned. The state is the same on every tier, so a
stream may change tier between chunks.

What the tier is chosen by (`tier_facts`: whether a fused tier serves the
configuration, whether it is the planar one, the factoring and the
dtypes) is worked out here alone; the mesh (`parallel/sharded_wideband`)
reads it. A chunk's plan (`_plan`: the tier, the chain's configuration,
the factoring, the planar row order and its inverse on the device) is
worked out on a stream's first chunk and held for each (configuration,
device) (`utils/held.plan`), as are the tables its kernels read of the
parameters (`utils/held.FromTensors`). `utils/held.clear()` forgets them
all.

Under a running `torch.profiler`, `process` records its host work as spans
(`utils/profiling.span`): `wideband.process` around the chunk, and inside
it `wideband.ingest` (the input to the device), `wideband.plan` (the tier
and what the configuration derives), `wideband.channelize` (the
channelizer's call), `wideband.history` (the next chunk's FIR history,
where the tier cuts it) and the chain's `chain.tail` or `chain.process`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

from supersdr_tpu_torch.device import default_device
from supersdr_tpu_torch.ops import channelizer, cx, fir_matmul
from supersdr_tpu_torch.ops.cuda import channelize_fused, pfb_fold
from supersdr_tpu_torch.runtime import chain
from supersdr_tpu_torch.utils import held, profiling

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
_CHAN_IMPLS = ("legacy", "mxu2", "mxu2conv", "mxu2pallas", "mxu2fused",
               "stub", "nofft")
_MXU2_FOLDS = {"mxu2": "slices", "mxu2conv": "conv", "mxu2pallas": "pallas"}


@dataclass(frozen=True)
class WidebandConfig:
    """fs_in must equal n_chan·chain.iq_rate (critical sampling). Field
    names, order, defaults and checks follow the reference's, so one
    keyword set builds both. `pallas_fold` routes the chan-major
    channelizer through the fold kernel (`ops/cuda/pfb_fold.py`), and so
    does `chan_impl="mxu2pallas"`; `channelize_dispatch` routes every
    other `chan_impl` as the reference does. The DFT layout knobs
    (`mxu_chan_fft`, `chan_fft_form`, `chan_precision` off the fused
    channelizer) name the reference's forms of one DFT, which the port
    takes as `torch.fft` in float32; `chan_fold_dtype="f16"` rounds the
    fold's input as the reference does. `chan_split2` is the TPU kernel's
    stage-B blocking: the port accepts it and ignores it (its kernel runs
    stage B unsplit on every tier), and `audio_channel_order` gives the
    port's row order."""
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
    mxu_chan_fft: bool = False
    chan_impl: str = "legacy"
    chan_fold_dtype: str = "f32"
    chan_precision: str = "highest"
    tail_impl: str = "xla"
    chan_fft_form: str = "dif"
    time_major: bool = False
    chan_tile_t: int = 128
    chan_split2: str = "auto"
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
        if self.chan_split2 not in ("auto", "on", "off"):
            raise ValueError("chan_split2 must be 'auto', 'on' or 'off'")
        if self.chan_factors is not None:
            n1f, n2f = self.chan_factors
            if n1f * n2f != self.n_chan or n2f % 128:
                raise ValueError("chan_factors must multiply to n_chan "
                                 "with a lane-multiple n2")
        if self.chan_impl not in _CHAN_IMPLS:
            raise ValueError(f"chan_impl must be one of {_CHAN_IMPLS} "
                             "(stub/nofft: knockout profiling)")

    @property
    def iq_rate(self) -> int:
        return self.fs_in // self.n_chan

    @property
    def chunk_per_chan(self) -> int:
        return self.chunk_in // self.n_chan

    @cached_property
    def chain_cfg(self) -> chain.ChainConfig:
        # PFB outputs are channel-centred: the NCO pass is compiled out;
        # made once and held by the (frozen) instance
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
            and chain.pallas_tail_ok(ccfg, (cfg.n_chan,))):
        return False
    if chain.tail_fir_block(ccfg) is not None:
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
    return chain.tail_fir_block(cfg.chain_cfg) is not None


def _factors_for(cfg: WidebandConfig) -> tuple[int, int] | None:
    """The DIF factoring (n1, n2): `chan_factors` when given, else the
    default tree, whatever `chan_split2` says. The reference's quality
    tier picks a min-n1 tree to pair with its stage-B split; without the
    split that tree only makes stage B larger, so the port keeps the
    default tree in both tiers."""
    if cfg.chan_factors is not None:
        return tuple(cfg.chan_factors)
    return channelizer._pick_factors(cfg.n_chan)


class TierFacts(NamedTuple):
    """What a configuration's tier is chosen by, worked out on the host
    (`tier_facts`); the serial plan (`_plan`) and the mesh's
    (`parallel/sharded_wideband`) read them."""
    fused: bool                    # a time-major fused tier serves it:
                                   # `time_major` and `_tmajor_fused_ok`
    planar: bool                   # the planar one: `_planar_active`
    factors: tuple | None          # the DIF factoring, `_factors_for`
    bf16_mxu: bool                 # stage B on bf16 operands
    raw_dtype: torch.dtype         # the planar planes' dtype
    audio_dtype: torch.dtype


def tier_facts(cfg: WidebandConfig) -> TierFacts:
    """The configuration's `TierFacts`, by the reference's predicates."""
    fused = cfg.time_major and _tmajor_fused_ok(cfg)
    return TierFacts(
        fused=fused, planar=_planar_active(cfg),
        factors=_factors_for(cfg),
        bf16_mxu=cfg.chan_precision == "default",
        raw_dtype=(torch.bfloat16 if cfg.chan_precision == "default"
                   and cfg.passband_precision == "default"
                   else torch.float32),
        audio_dtype=_AUDIO_DTYPES[cfg.audio_dtype])


def audio_channel_order(cfg: WidebandConfig) -> np.ndarray:
    """order[i] = PFB bin of audio/RSSI row i: the planar order of the
    factoring on the planar tier (`channelize_fused.planar_order`),
    identity elsewhere."""
    if not _planar_active(cfg):
        return np.arange(cfg.n_chan)
    return channelize_fused.planar_order(cfg.n_chan, *_factors_for(cfg))


def channel_freqs(cfg: WidebandConfig, center_hz: float = 0.0,
                  order: np.ndarray | None = None) -> np.ndarray:
    """Centre frequency of each output row given the capture centre."""
    freqs = center_hz + channelizer.channel_center_freqs(pfb_plan(cfg),
                                                         cfg.fs_in)
    if order is None:
        order = audio_channel_order(cfg)
    return freqs[np.asarray(order)]


def is_i16_pair(iq) -> bool:
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


def _count_crossings(planes, device: torch.device) -> None:
    """Count (`profiling.count_sync`) each plane that reaches `device`
    by a copy from the host, which the host waits for."""
    if profiling.recording() and device.type != "cpu":
        for p in planes:
            if not (isinstance(p, torch.Tensor) and p.device == device):
                profiling.count_sync()


def coerce(iq, device):
    """A chunk on `device`: an int16 pair as a pair of contiguous int16
    tensors, anything else as a CX of float32 planes (`cx.as_cx`); each
    plane copied from the host counted (`_count_crossings`)."""
    if is_i16_pair(iq):
        _count_crossings(iq, device)
        return tuple(torch.as_tensor(p).to(device).contiguous() for p in iq)
    # a complex array or tensor crosses as two planes, as a CX does
    _count_crossings(iq if isinstance(iq, cx.CX) else (iq, iq), device)
    return cx.as_cx(iq, device=device)


def _as_f32_cx(iq) -> cx.CX:
    """CX as it is; an int16 pair dequantized (±32768 ≡ ±1.0)."""
    if isinstance(iq, cx.CX):
        return iq
    return cx.CX(iq[0].float() * (1.0 / 32768.0),
                 iq[1].float() * (1.0 / 32768.0))


def channelize_dispatch(cfg: WidebandConfig, params: WidebandParams,
                        carry: cx.CX, iq: cx.CX
                        ) -> tuple[cx.CX, torch.Tensor]:
    """The chan-major channelizer, routed as the reference's: `pallas_fold`
    or "mxu2pallas" on a 128-multiple n_chan → the fold kernel +
    `torch.fft`; "stub" → the chunk reshaped to [n/M, M] and transposed,
    the carry passed through (a knockout with no fold and no DFT, defined
    but meaningless); "nofft" → the float16 slice fold, transposed, with
    no DFT (a knockout); "mxu2fused" on a lane-aligned factoring and
    8-aligned frames → the fused channelizer kernel, its planes permuted
    to bin order (the reference's out_layout="chan"); "mxu2" /
    "mxu2conv" / "mxu2pallas" → `channelize_mxu2_n` with the slice,
    convolution or kernel fold and `chan_fold_dtype`; "legacy" and the
    rest of "mxu2fused" → `channelize_c`.

    carry: CX [history]; iq: CX [n] float32 planes. Returns (new carry CX,
    chans complex64 [n_chan, n/n_chan]). With a leading shard axis, carry
    [D, history] and iq [D, n] (each time shard with its own history: the
    sharded pipeline's fallback tier), each shard's new carry and chans
    [D, n_chan, n/n_chan], one launch for all shards."""
    plan = pfb_plan(cfg)
    M, K = cfg.n_chan, cfg.taps_per
    nf = iq.re.shape[-1] // M
    lead = iq.re.shape[:-1]
    if cfg.pallas_fold or (cfg.chan_impl == "mxu2pallas" and M % 128 == 0):
        G = channelizer.fold_taps(params.W_pfb, K, M)
        return pfb_fold.channelize_pallas_c(plan, G, carry, iq)
    if cfg.chan_impl == "stub":
        chans = torch.complex(iq.re, iq.im).reshape(*lead, nf, M)
        return carry, chans.transpose(-1, -2)
    fac = channelizer._pick_factors(M)
    if cfg.chan_impl == "mxu2fused" and fac is not None \
            and fac[1] % 128 == 0 and nf % 8 == 0:
        new_carry, (raw_r, raw_i) = channelize_fused.channelize_fused_raw3(
            plan, params.W_pfb, carry, iq, factors=fac,
            bf16_mxu=cfg.chan_precision == "default",
            out_dtype=torch.float32)
        # [n1(k1), nf, n2(k2)] → bin m = k2·n1 + k1: [n2, n1, nf] → [M, nf]
        return new_carry, torch.complex(
            raw_r.movedim(-1, -3).reshape(*lead, M, nf),
            raw_i.movedim(-1, -3).reshape(*lead, M, nf))
    carry_c = torch.complex(carry.re, carry.im)
    x = torch.complex(iq.re, iq.im)
    if cfg.chan_impl == "nofft":
        c, fold = channelizer._fold_mxu2(plan, params.W_pfb, carry_c, x,
                                         "slices", torch.float16)
        chans = fold.transpose(-1, -2)
    elif cfg.chan_impl in _MXU2_FOLDS:
        c, chans = channelizer.channelize_mxu2_n(
            plan, params.W_pfb, carry_c, x,
            fold_impl=_MXU2_FOLDS[cfg.chan_impl],
            fold_dtype=(torch.float16 if cfg.chan_fold_dtype == "f16"
                        else torch.float32))
    else:
        c, chans = channelizer.channelize_c(plan, params.W_pfb, carry_c, x)
    return cx.CX(c.real.contiguous(), c.imag.contiguous()), chans


class _Plan(NamedTuple):
    """What a chunk's tier needs of the configuration, worked out on the
    host on a stream's first chunk and held."""
    tier: object                   # the tier's function
    ccfg: chain.ChainConfig
    pfb: channelizer.PFBPlan
    facts: TierFacts
    factors: tuple | None          # the channelizer's (n1, n2)
    order: torch.Tensor | None     # planar row → bin, on the device
    inv: torch.Tensor | None       # its inverse: bin → planar row


@held.plan
def _plan(cfg: WidebandConfig, device: torch.device) -> _Plan:
    facts = tier_facts(cfg)
    plan = _Plan(tier=_process_fallback, ccfg=cfg.chain_cfg,
                 pfb=pfb_plan(cfg), facts=facts, factors=None, order=None,
                 inv=None)
    if not cfg.time_major:
        return plan._replace(tier=_process_chan_major)
    if facts.planar:
        # both on the device once: a copy from host memory every chunk
        # would wait for the card, an argsort every chunk is a device sort
        order = audio_channel_order(cfg)
        return plan._replace(
            tier=_process_planar, factors=facts.factors,
            order=torch.as_tensor(order, device=device),
            inv=torch.as_tensor(np.argsort(order), device=device))
    if facts.fused:
        return plan._replace(tier=_process_tmajor_fused,
                             factors=channelizer._pick_factors(cfg.n_chan))
    return plan


def _process_chan_major(cfg: WidebandConfig, plan: _Plan,
                        params: WidebandParams, state: WidebandState, iq
                        ) -> tuple[WidebandState, chain.ChainOutput]:
    with profiling.span("wideband.channelize"):
        pfb_carry, chans = channelize_dispatch(cfg, params, state.pfb_carry,
                                               _as_f32_cx(iq))
    with profiling.span("chain.process"):
        cstate, out = chain.process_traced(plan.ccfg, params.chain,
                                           state.chain, chans)
    return WidebandState(pfb_carry=pfb_carry, chain=cstate), out


def _process_planar(cfg: WidebandConfig, plan: _Plan,
                    params: WidebandParams, state: WidebandState, iq
                    ) -> tuple[WidebandState, chain.ChainOutput]:
    ccfg = plan.ccfg
    with profiling.span("wideband.channelize"):
        pfb_carry, (raw_r, raw_i) = channelize_fused.channelize_fused_raw3(
            plan.pfb, params.W_pfb, state.pfb_carry, iq,
            factors=plan.factors, bf16_mxu=plan.facts.bf16_mxu,
            out_dtype=plan.facts.raw_dtype)
    # next chunk's FIR history: the raw tail [n1, ov, n2] → [n2, n1, ov]
    # → [M, ov], row k2·n1 + k1: bin order
    with profiling.span("wideband.history"):
        ov = ccfg.n_taps - 1
        os_carry = cx.CX(
            raw_r[:, -ov:, :].permute(2, 0, 1).reshape(cfg.n_chan, ov)
            .float(),
            raw_i[:, -ov:, :].permute(2, 0, 1).reshape(cfg.n_chan, ov)
            .float())
    cstate, audioT, rssi = chain.process_tail_tmajor(
        ccfg, params.chain, state.chain, state.chain.phase, os_carry,
        fir_x3=(raw_r, raw_i), chan_order=plan.order, chan_inv=plan.inv,
        audio_dtype=plan.facts.audio_dtype)
    return (WidebandState(pfb_carry=pfb_carry, chain=cstate),
            chain.ChainOutput(audio=audioT, rssi=rssi, baseband=None))


def _process_tmajor_fused(cfg: WidebandConfig, plan: _Plan,
                          params: WidebandParams, state: WidebandState, iq
                          ) -> tuple[WidebandState, chain.ChainOutput]:
    """The time-major tier off the planar coupling: the channelizer kernel
    writes bin-ordered planes [nf, M] (an int16 pair goes to it as it is
    and is dequantized in the kernel); with an in-tail FIR block the FIR
    tail reads them (no baseband output), else the time-major Toeplitz
    passband runs alone and the non-FIR tail takes its yT."""
    ccfg = plan.ccfg
    with profiling.span("wideband.channelize"):
        pfb_carry, chansT = channelize_fused.channelize_fused_c(
            plan.pfb, params.W_pfb, state.pfb_carry, iq,
            factors=plan.factors, bf16_mxu=plan.facts.bf16_mxu,
            out_layout="time")
    chansT = cx.CX(*chansT)
    with profiling.span("wideband.history"):
        ov = ccfg.n_taps - 1
        os_carry = cx.CX(chansT.re[-ov:].T.contiguous(),
                         chansT.im[-ov:].T.contiguous())
    kw = dict(audio_dtype=plan.facts.audio_dtype)
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


def _process_fallback(cfg: WidebandConfig, plan: _Plan,
                      params: WidebandParams, state: WidebandState, iq
                      ) -> tuple[WidebandState, chain.ChainOutput]:
    """The time-major layout off the fused tiers: the chan-major
    pipeline plus one transpose."""
    st, out = _process_chan_major(cfg, plan, params, state, iq)
    audioT = out.audio.T.to(plan.facts.audio_dtype).contiguous()
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
    device = params.W_pfb.device
    with profiling.span("wideband.process"):
        with profiling.span("wideband.ingest"):
            iq = coerce(iq, device)
        with profiling.span("wideband.plan"):
            plan = _plan(cfg, device)
        return plan.tier(cfg, plan, params, state, iq)


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
