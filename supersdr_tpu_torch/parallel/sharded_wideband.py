"""The wideband pipeline sharded over time, then over channels.

Counterpart of `supersdr_tpu/parallel/sharded_wideband.py` (the
Ulysses-style reshard). Two phases with different natural shardings:

  1. channelize: the capture is cut into D contiguous time shards; each
     shard runs the channelizer with its filter history brought in by a
     halo exchange (`collectives.left_halo`), shard 0 taking the carried
     stream state, exactly as the serial carry would provide;
  2. demodulate: the receivers are channel-parallel; an `all_to_all`
     reshards [channels, frames] from time-split to channel-split, after
     which every channel shard runs full-length chains with no further
     communication. Last, the last time shard's input tail is broadcast
     (`collectives.broadcast_last`) as the next call's PFB history.

The mesh lives on one device, as `parallel/sharded_chain.py`'s: the D
shards are a leading tensor axis there, one launch of each op serves every
shard, and only `collectives` knows that shards are neighbours. The tiers
are the reference's:

  planar      the channelizer kernel writes raw planes [D, n1_pad, f_local,
              n2], with `n1_pad − n1` phantom planes of zeros when D does
              not divide n1; the all_to_all over the plane axis gives
              [D, n1_pad/D, D·f_local, n2], which on one device is the
              planes of every channel shard, [n1_pad, frames, n2]: ONE FIR
              tail launch filters them, on a state kept in (padded) planar
              channel order. The factoring is chosen per shard count
              (`_planar_factors_for`), preferring the serial factoring's
              n2, so a shard count that divides the serial n1 runs the
              serial kernel program;
  time-major  the channelizer's time store [D, f_local, M], the all_to_all
              over the channel axis ([D, frames, M/D], bin order), then the
              FIR tail reading it as planes of M/D channels, or the
              time-major Toeplitz passband and the non-FIR tail;
  fallback    `wideband.channelize_dispatch` over the shards, the
              all_to_all over the channel axis, `chain.process_traced`.

The public params and state are the serial wideband's (`wideband.make_params`
/ `init_state`), in bin order; `process.channel_order` maps audio and RSSI
rows to PFB bins. Where the reference differs (ROADMAP queue 3): its
`n2_pref` (256, or 512 for its split quality tier) ignores `chan_factors`
and the port's unsplit stage B; the port prefers the n2 of the serial
factoring, `wideband._factors_for`. And its planar predicate does not ask
for an in-tail FIR block, which the serial planar predicate does; the
port's does, so a passband too short for one goes to the time-major tier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from supersdr_tpu_torch.device import default_device
from supersdr_tpu_torch.ops import channelizer, cx, fir_matmul
from supersdr_tpu_torch.ops.cuda import channelize_fused
from supersdr_tpu_torch.parallel import collectives
from supersdr_tpu_torch.runtime import chain as chain_mod
from supersdr_tpu_torch.runtime import wideband as wb

# Padded-planar cutoff, the reference's: the phantom-plane fraction above
# which the reference takes the padded planar form to lose to its
# transposed fallback (a model estimate there, not measured on a card).
PLANAR_WASTE_MAX = 0.34

I16_SCALE = 1.0 / 32768.0


@dataclass(frozen=True)
class Mesh:
    """One axis of `n_shards` shards on one `torch.device`."""
    n_shards: int
    device: torch.device


def make_mesh(n_shards: int | None = None, device=None) -> Mesh:
    """A mesh of `n_shards` shards (the reference's device count) on
    `device` (the current CUDA device unless one is given; without a card
    pass device="cpu"). None: as many shards as the host has CUDA devices
    (the reference's default, every device), 1 on the CPU."""
    device = default_device(device)
    if n_shards is None:
        n_shards = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_shards < 1:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    return Mesh(int(n_shards), device)


def _planar_factors_for(n_chan: int, d: int, n2_pref: int = 256
                        ) -> tuple[int, int, int] | None:
    """(n1, n2, n1_pad) for a d-shard planar mesh: among the DIF factorings
    with a lane-multiple n2 (n1 ≥ 2), the least padded waste n1_pad·n2 −
    n_chan (n1_pad = ceil(n1/d)·d), ties toward `n2_pref`, then the larger
    n2. None if no factoring exists."""
    cands = []
    for n2 in range(128, min(512, n_chan) + 1, 128):
        if n_chan % n2 == 0 and 2 <= n_chan // n2 <= channelizer.MAX_DIRECT:
            n1 = n_chan // n2
            n1_pad = -(-n1 // d) * d
            cands.append((n1_pad * n2 - n_chan, abs(n2 - n2_pref), -n2,
                          n1, n2, n1_pad))
    if not cands:
        return None
    _, _, _, n1, n2, n1_pad = min(cands)
    return n1, n2, n1_pad


def _mesh_tile(f_local: int, cfg: wb.WidebandConfig) -> int:
    """The reference's frame tile on a shard: the largest multiple-of-8
    divisor of the local frame count, capped at `chan_tile_t` (and at 112
    on its float32 tiers). The port's kernel takes T ∈ {2, 4, 8} frames a
    block (`channelize_fused_tile`) and masks the ragged last block, so
    any tile the predicate accepts (≥ 8, dividing f_local) also suits it."""
    cap = cfg.chan_tile_t
    if cfg.chan_precision != "default":
        cap = min(cap, 112)
    best = 0
    for t in range(8, cap + 1, 8):
        if f_local % t == 0:
            best = t
    return best


def _planar_order(n_chan: int, n1: int, n2: int,
                  split_levels: int = 0) -> np.ndarray:
    """order[c] = PFB bin of planar row c (c = k1·n2 + col → bin
    k2(col)·n1 + k1), for the real rows only."""
    colmap = channelizer.stageb_col_to_k2(n2, split_levels)
    c = np.arange(n_chan)
    return colmap[c % n2] * n1 + c // n2


class MeshPlan(NamedTuple):
    """How `build` runs a config on d shards."""
    tier: str                  # "planar", "tmajor" or "fallback"
    factors: tuple | None      # planar: (n1, n2, n1_pad)
    f_local: int               # frames a shard


def plan_mesh(cfg: wb.WidebandConfig, d: int,
              planar_waste_max: float | None = None) -> MeshPlan:
    """The tier and factoring for `cfg` on `d` shards: the reference's
    predicates, with the serial factoring's n2 preferred and, for the
    planar tier, an in-tail FIR block required (as the serial planar
    predicate requires it)."""
    if cfg.n_chan % d or cfg.chunk_in % (d * cfg.n_chan):
        raise ValueError("n_shards must divide n_chan and chunk_in/n_chan")
    waste_max = (PLANAR_WASTE_MAX if planar_waste_max is None
                 else planar_waste_max)
    ccfg = cfg.chain_cfg
    f_local = cfg.chunk_in // (d * cfg.n_chan)
    tile = _mesh_tile(f_local, cfg)
    fused = cfg.time_major and wb._tmajor_fused_ok(cfg)
    serial = wb._factors_for(cfg)
    pf = _planar_factors_for(cfg.n_chan, d,
                             serial[1] if serial is not None else 256)
    if fused and pf is not None:
        n1, n2, n1_pad = pf
        c_loc = (n1_pad // d) * n2
        waste = (n1_pad * n2 - cfg.n_chan) / cfg.n_chan
        fir_block = fir_matmul.tail_fir_block(
            ccfg.chunk, ccfg.n_taps,
            chain_mod._tail_tile(ccfg.chunk, ccfg.n_taps))
        if (chain_mod._pallas_tail_ok(ccfg, (c_loc,)) and c_loc % 128 == 0
                and tile >= 8 and f_local % 8 == 0 and waste <= waste_max
                and fir_block is not None):
            return MeshPlan("planar", pf, f_local)
    if fused and chain_mod._pallas_tail_ok(ccfg, (cfg.n_chan // d,)) \
            and f_local % 8 == 0:
        return MeshPlan("tmajor", None, f_local)
    return MeshPlan("fallback", None, f_local)


def _map_state(fn, tree):
    """`fn` applied to every tensor leaf of a (nested) NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(None if v is None else _map_state(fn, v)
                        for v in tree))


def _as_shards(iq, d: int, n: int):
    """A coerced chunk of n samples (CX of float32 planes or an int16
    pair) as [d, n/d] planes, views of the chunk: (re, im, is_i16)."""
    re, im = (iq.re, iq.im) if isinstance(iq, cx.CX) else iq
    if tuple(re.shape) != (n,) or tuple(im.shape) != (n,):
        raise ValueError(f"a chunk must be [{n}] samples, got "
                         f"{tuple(re.shape)}")
    return re.reshape(d, -1), im.reshape(d, -1), re.dtype == torch.int16


def _halo_head(re: torch.Tensor, im: torch.Tensor, carry: cx.CX,
               history: int) -> cx.CX:
    """Each shard's PFB history [d, history], float32: the left
    neighbour's last samples through the halo exchange, the carried stream
    state on shard 0; int16 halos are dequantized (the head is a small
    buffer)."""
    if re.dtype != torch.int16:
        hr, hi = collectives.left_halo((re, im), history,
                                       head0=(carry.re, carry.im))
        return cx.CX(hr, hi)
    hr, hi = collectives.left_halo((re, im), history)
    hr = hr.float() * I16_SCALE
    hi = hi.float() * I16_SCALE
    hr[0] = carry.re
    hi[0] = carry.im
    return cx.CX(hr, hi)


def build(cfg: wb.WidebandConfig, mesh: Mesh,
          planar_waste_max: float | None = None):
    """The sharded wideband pipeline for `mesh`.

    Constraints: the shard count divides n_chan and chunk_in/n_chan, and a
    shard holds at least the PFB history. `planar_waste_max` overrides
    `PLANAR_WASTE_MAX`. Returns process(params, state, iq[chunk_in]) ->
    (state, audio, rssi) with audio [n_chan, chunk_per_chan·L]
    (time-major configs: [chunk_per_chan·L, n_chan], rows per
    `process.channel_order`), rssi [n_chan, rows]. `process.process_n(params,
    state, iqs)` is the N-chunk form with tuple outputs (serial
    `wideband.process_n` semantics, the RSSI of the last chunk); both take
    CX, complex numpy or (re_i16, im_i16) int16 pairs per chunk, kinds mixed
    freely. Params and state are the serial wideband's and must lie on
    `mesh.device`.
    """
    d = mesh.n_shards
    mp = plan_mesh(cfg, d, planar_waste_max)
    plan = wb.pfb_plan(cfg)
    h = plan.history
    if cfg.chunk_in // d < h:
        raise ValueError(f"a shard of {cfg.chunk_in // d} samples is shorter "
                         f"than the PFB history ({h})")
    wb._check_ported(cfg)
    ccfg = cfg.chain_cfg
    M = cfg.n_chan
    ov = ccfg.n_taps - 1
    fast = cfg.chan_precision == "default"
    audio_dtype = wb._AUDIO_DTYPES[cfg.audio_dtype]
    planar = mp.tier == "planar"
    if planar:
        n1, n2, n1_pad = mp.factors
        C_pad = n1_pad * n2
        order = _planar_order(M, n1, n2, wb._split_levels_for(cfg, n2))
        raw_dtype = (torch.bfloat16 if fast
                     and cfg.passband_precision == "default"
                     else torch.float32)
    else:
        C_pad = M
        order = np.arange(M)
    # row → state row on the padded state: the real rows' bins, then the
    # phantom rows, which keep the padded tail of the state
    state_rows = torch.as_tensor(
        np.concatenate([order, np.arange(M, C_pad)]), device=mesh.device)
    bin_rows = torch.arange(M, device=mesh.device)

    def pad0(v):
        if C_pad == M:
            return v
        return torch.cat([v, v.new_zeros((C_pad - M,) + v.shape[1:])])

    def step_planar(params, state, re, im, i16):
        head = _halo_head(re, im, state.pfb_carry, h)
        x = (re, im) if i16 else cx.CX(re, im)
        tails, (raw_r, raw_i) = channelize_fused.channelize_fused_c(
            plan, params.W_pfb, head, x, factors=(n1, n2), bf16_mxu=fast,
            out_dtype=raw_dtype, n1_pad=n1_pad)
        # reshard over the plane axis: [d, n1_pad, f_local, n2] → [d,
        # n1_pad/d, d·f_local, n2]; on one device every channel shard's
        # planes together are [n1_pad, frames, n2]
        nf = d * mp.f_local
        raw_r = collectives.all_to_all(raw_r, 0, 1).reshape(C_pad // n2, nf,
                                                              n2)
        raw_i = collectives.all_to_all(raw_i, 0, 1).reshape(C_pad // n2, nf,
                                                              n2)
        # next chunk's FIR history in bin order (row col·n1 + k1 is bin
        # k2·n1 + k1), the phantom rows' zeros after it
        os_carry = cx.CX(*(pad0(r[:n1, -ov:, :].permute(2, 0, 1)
                                .reshape(M, ov).float())
                           for r in (raw_r, raw_i)))
        cstate, audioT, rssi = chain_mod.process_tail_tmajor(
            ccfg, params.chain, state.chain, state.chain.phase, os_carry,
            fir_x3=(raw_r, raw_i), chan_order=state_rows,
            audio_dtype=audio_dtype)
        return tails, cstate, audioT, rssi

    def step_tmajor(params, state, re, im, i16):
        head = _halo_head(re, im, state.pfb_carry, h)
        x = (re, im) if i16 else cx.CX(re, im)
        tails, (tr, ti) = channelize_fused.channelize_fused_c(
            plan, params.W_pfb, head, x,
            factors=channelizer._pick_factors(M), bf16_mxu=fast,
            out_layout="time")
        # reshard over the channel axis: [d, f_local, M] → [d, d·f_local,
        # M/d], channel shard c holding bins c·M/d …, in bin order
        tr = collectives.all_to_all(tr, 1, 0)
        ti = collectives.all_to_all(ti, 1, 0)
        os_carry = cx.CX(*(p[:, -ov:, :].permute(0, 2, 1).reshape(M, ov)
                           for p in (tr, ti)))
        kw = dict(audio_dtype=audio_dtype)
        if params.chain.W_tailpass is not None and (M // d) % 8 == 0:
            # the FIR tail reads the shards' planes as they lie
            kw.update(fir_x3=(tr, ti), chan_order=bin_rows)
        else:
            xT = cx.CX(*(p.movedim(0, 1).reshape(-1, M) for p in (tr, ti)))
            if params.chain.W_tailpass is not None:
                kw["fir_x"] = xT
            else:
                carry_T = cx.CX(state.chain.os_carry.re.T,
                                state.chain.os_carry.im.T)
                _, kw["yT"] = fir_matmul.fir_matmul_stream_tmajor_c(
                    ccfg.fir_plan, params.chain.W_pass, carry_T, xT)
        cstate, audioT, rssi = chain_mod.process_tail_tmajor(
            ccfg, params.chain, state.chain, state.chain.phase, os_carry,
            **kw)
        return tails, cstate, audioT, rssi

    def step_fallback(params, state, re, im, i16):
        head = _halo_head(re, im, state.pfb_carry, h)
        if i16:
            re, im = re.float() * I16_SCALE, im.float() * I16_SCALE
        tails, chans = wb.channelize_dispatch(cfg, params, head,
                                              cx.CX(re, im))
        # reshard: [d, M, f_local] → [d, M/d, d·f_local], i.e. [M, frames]
        chans = collectives.all_to_all(chans, 0, 1).reshape(M, -1)
        cstate, out = chain_mod.process_traced(ccfg, params.chain,
                                               state.chain, chans)
        audio = out.audio
        if cfg.time_major:
            audio = audio.T.to(audio_dtype).contiguous()
        return tails, cstate, audio, out.rssi

    step = {"planar": step_planar, "tmajor": step_tmajor,
            "fallback": step_fallback}[mp.tier]

    def process_n(params, state, iqs):
        """N consecutive chunks, state threaded through; returns (state,
        audio tuple, RSSI of the last chunk)."""
        dev = params.W_pfb.device
        if dev != mesh.device:
            raise ValueError(f"params lie on {dev}, the mesh on "
                             f"{mesh.device}")
        if planar:       # the padded state, its rows after the real ones
            state = state._replace(chain=_map_state(pad0, state.chain))
        audios, rssi = [], None
        for iq in iqs:
            re, im, i16 = _as_shards(wb._coerce(iq, dev), d, cfg.chunk_in)
            tails, cstate, audio, rssi = step(params, state, re, im, i16)
            last = cx.CX(*(collectives.broadcast_last(t)[0] for t in tails))
            state = wb.WidebandState(pfb_carry=last, chain=cstate)
            audios.append(audio)
        if planar:
            state = state._replace(
                chain=_map_state(lambda v: v[:M], state.chain))
            audios = [a[:, :M] for a in audios]
            rssi = rssi[:M]
        return state, tuple(audios), rssi

    def process(params, state, iq):
        """iq: [chunk_in] — CX / complex numpy / (re_i16, im_i16)."""
        st, audios, rssi = process_n(params, state, (iq,))
        return st, audios[0], rssi

    process.process_n = process_n
    # audio/RSSI row → PFB bin: the planar order of the mesh's factoring on
    # the planar tier, bin order otherwise
    process.channel_order = order
    process.planar = planar
    process.planar_factors = mp.factors if planar else None
    process.tier = mp.tier
    return process


def make_params(cfg: wb.WidebandConfig, device=None,
                **kw) -> wb.WidebandParams:
    """The serial wideband's params (the mesh keeps no params of its
    own)."""
    return wb.make_params(cfg, device=device, **kw)


def init_state(cfg: wb.WidebandConfig, device=None) -> wb.WidebandState:
    """The serial wideband's zero stream state."""
    return wb.init_state(cfg, device=device)

