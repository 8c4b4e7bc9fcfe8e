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

The shards are a leading tensor axis, as in `parallel/sharded_chain.py`:
one launch of each op serves every shard of a process, and only the mesh's
transport (`collectives`) knows that shards are neighbours. In one process
the axis holds all D shards; with a process group of `world` processes it
holds this process's D_local = D / world (rank r: global shards r·D_local
…), and after the reshard each process holds C_pad / world rows (its
planes, or its bins on the other tiers): its chain state and its audio and
RSSI columns are those rows (`process.gather_state` / `gather_rows` gather
them). The tiers are the reference's:

  planar      the channelizer kernel writes raw planes [D, n1_pad, f_local,
              n2], with `n1_pad − n1` phantom planes of zeros when D does
              not divide n1; the all_to_all over the plane axis gives
              [D, n1_pad/D, D·f_local, n2], which in one process is the
              planes of every channel shard, [n1_pad, frames, n2] (a
              process's n1_pad/world of them across processes): ONE FIR
              tail launch filters them, on a state kept in (padded) planar
              channel order. The factoring is chosen per shard count
              (`_planar_factors_for`), preferring the serial factoring's
              n2, so a shard count that divides the serial n1 runs the
              serial kernel program;
  time-major  the channelizer's time store [D, f_local, M], the all_to_all
              over the channel axis ([D, frames, M/D], bin order), then the
              FIR tail reading it as planes of M/D channels, or the
              time-major Toeplitz passband and the non-FIR tail;
  fallback    `wideband.channelize_dispatch` over the shards (every
              `chan_impl`, as the reference's), the all_to_all over the
              channel axis, `chain.process_traced`.

The public params and state are the serial wideband's (`wideband.make_params`
/ `init_state`), in bin order; `process.channel_order` maps audio and RSSI
rows to PFB bins. Where the reference differs (ROADMAP queue 3): its
`n2_pref` (256, or 512 for its split quality tier) ignores `chan_factors`
and the port's unsplit stage B; the port prefers the n2 of the serial
factoring. And its planar predicate does not ask for an in-tail FIR block,
which the serial planar predicate does; the port's does, so a passband too
short for one goes to the time-major tier.

The rules this module reads and does not write again: the serial tier
facts (whether a fused tier serves the configuration, its factoring, the
raw-plane and audio dtypes) and the input's coercion from
`runtime/wideband.py` (`tier_facts`, `coerce`); the fused tail's predicate
and the in-tail FIR block from `runtime/chain.py` (`pallas_tail_ok`,
`tail_fir_block`); the planar row order from the channelizer that writes
the planes (`channelize_fused.planar_order`). What is the mesh's own: the
factoring per shard count, the padded planes and `PLANAR_WASTE_MAX`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
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
    """One axis of `n_shards` shards on one `torch.device`, split over the
    processes of `comm`."""
    n_shards: int
    device: torch.device
    comm: collectives.Transport = field(
        default_factory=collectives.Transport, compare=False, repr=False)

    @property
    def rank(self) -> int:
        return self.comm.rank

    @property
    def world(self) -> int:
        return self.comm.world

    @property
    def d_local(self) -> int:
        """Shards in this process."""
        return self.n_shards // self.comm.world


def make_mesh(n_shards: int | None = None, device=None, *,
              world: int | None = None) -> Mesh:
    """A mesh of `n_shards` shards (the reference's device count) on
    `device` (the current CUDA device unless one is given; without a card
    pass device="cpu"). None: as many shards as the host has CUDA devices
    (the reference's default, every device), 1 on the CPU. The shards split
    over the processes of an initialised `torch.distributed` group
    (`collectives.for_processes`; `world=1`: all in this process)."""
    device = default_device(device)
    if n_shards is None:
        n_shards = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_shards < 1:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    return Mesh(int(n_shards), device,
                collectives.for_processes(int(n_shards), device, world))


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
    facts = wb.tier_facts(cfg)
    pf = _planar_factors_for(cfg.n_chan, d, facts.factors[1]
                             if facts.factors is not None else 256)
    if facts.fused and pf is not None:
        n1, n2, n1_pad = pf
        c_loc = (n1_pad // d) * n2
        waste = (n1_pad * n2 - cfg.n_chan) / cfg.n_chan
        if (chain_mod.pallas_tail_ok(ccfg, (c_loc,)) and c_loc % 128 == 0
                and tile >= 8 and f_local % 8 == 0 and waste <= waste_max
                and chain_mod.tail_fir_block(ccfg) is not None):
            return MeshPlan("planar", pf, f_local)
    if facts.fused and chain_mod.pallas_tail_ok(ccfg, (cfg.n_chan // d,)) \
            and f_local % 8 == 0:
        return MeshPlan("tmajor", None, f_local)
    return MeshPlan("fallback", None, f_local)


def _map_state(fn, tree):
    """`fn` applied to every tensor leaf of a (nested) NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(None if v is None else _map_state(fn, v)
                        for v in tree))


def _as_shards(iq, d: int, n: int, comm):
    """A coerced chunk of n samples (CX of float32 planes or an int16
    pair) as this process's [d_local, n/d] planes, views of the chunk:
    (re, im, is_i16)."""
    re, im = (iq.re, iq.im) if isinstance(iq, cx.CX) else iq
    if tuple(re.shape) != (n,) or tuple(im.shape) != (n,):
        raise ValueError(f"a chunk must be [{n}] samples, got "
                         f"{tuple(re.shape)}")
    dl = d // comm.world
    re, im = (p.reshape(d, -1)[comm.rank * dl:(comm.rank + 1) * dl]
              for p in (re, im))
    return re, im, re.dtype == torch.int16


def _halo_head(re: torch.Tensor, im: torch.Tensor, carry: cx.CX,
               history: int, comm) -> cx.CX:
    """Each shard's PFB history [d_local, history], float32: the left
    neighbour's last samples through the halo exchange, the carried stream
    state on global shard 0; int16 halos are dequantized (the head is a
    small buffer)."""
    if re.dtype != torch.int16:
        hr, hi = comm.left_halo((re, im), history,
                                head0=(carry.re, carry.im))
        return cx.CX(hr, hi)
    hr, hi = comm.left_halo((re, im), history)
    hr = hr.float() * I16_SCALE
    hi = hi.float() * I16_SCALE
    if comm.rank == 0:                   # global shard 0
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

    With a process group every process passes the whole chunk and its own
    form of the state, `process.local_state(state)` of the serial one
    (whose chain part holds this process's rows), and gets back that form
    and its rows: `process.rows` columns of the audio and rows of the RSSI
    (phantom planar rows included); `process.gather_rows(t, dim)` and
    `process.gather_state(state)` give every process the whole audio, RSSI
    and serial state.
    """
    d = mesh.n_shards
    comm = mesh.comm
    mp = plan_mesh(cfg, d, planar_waste_max)
    plan = wb.pfb_plan(cfg)
    h = plan.history
    if cfg.chunk_in // d < h:
        raise ValueError(f"a shard of {cfg.chunk_in // d} samples is shorter "
                         f"than the PFB history ({h})")
    ccfg = cfg.chain_cfg
    M = cfg.n_chan
    ov = ccfg.n_taps - 1
    facts = wb.tier_facts(cfg)
    fast, audio_dtype = facts.bf16_mxu, facts.audio_dtype
    planar = mp.tier == "planar"
    if planar:
        n1, n2, n1_pad = mp.factors
        C_pad = n1_pad * n2
        order = channelize_fused.planar_order(M, n1, n2)
    else:
        C_pad = M
        order = np.arange(M)
    # row → state row on the padded state: the real rows' bins, then the
    # phantom rows, which keep the padded tail of the state
    state_rows = torch.as_tensor(
        np.concatenate([order, np.arange(M, C_pad)]), device=mesh.device)
    # the chain state a call holds: in one process the padded state in bin
    # order, its rows read through state_rows (as the serial planar path
    # reads them); across processes this process's rows of it, in row
    # order (`local_state`)
    n_rows = C_pad // comm.world
    my_rows = state_rows[comm.rank * n_rows:(comm.rank + 1) * n_rows]
    held_order = state_rows if comm.world == 1 else \
        torch.arange(n_rows, device=mesh.device)
    # and its inverse, made here once rather than sorted every chunk
    held_inv = torch.argsort(held_order)

    def pad0(v):
        if C_pad == M:
            return v
        return torch.cat([v, v.new_zeros((C_pad - M,) + v.shape[1:])])

    def step_planar(params, state, re, im, i16):
        head = _halo_head(re, im, state.pfb_carry, h, comm)
        x = (re, im) if i16 else cx.CX(re, im)
        tails, (raw_r, raw_i) = channelize_fused.channelize_fused_c(
            plan, params.W_pfb, head, x, factors=(n1, n2), bf16_mxu=fast,
            out_dtype=facts.raw_dtype, n1_pad=n1_pad)
        # reshard over the plane axis: [d, n1_pad, f_local, n2] → [d,
        # n1_pad/d, d·f_local, n2]; a process's channel shards' planes
        # together are its n1_pad/world planes, [planes, frames, n2]
        nf = d * mp.f_local
        raw_r = comm.all_to_all(raw_r, 0, 1).reshape(-1, nf, n2)
        raw_i = comm.all_to_all(raw_i, 0, 1).reshape(-1, nf, n2)
        # next chunk's FIR history in the held order: in one process bin
        # order (row k1·n2 + col is bin col·n1 + k1), the phantom rows'
        # zeros after it; across processes row order
        if comm.world == 1:
            os_carry = cx.CX(*(pad0(r[:n1, -ov:, :].permute(2, 0, 1)
                                    .reshape(M, ov).float())
                               for r in (raw_r, raw_i)))
        else:
            os_carry = cx.CX(*(r[:, -ov:, :].permute(0, 2, 1)
                               .reshape(n_rows, ov).float()
                               for r in (raw_r, raw_i)))
        cstate, audioT, rssi = chain_mod.process_tail_tmajor(
            ccfg, params.chain, state.chain, state.chain.phase, os_carry,
            fir_x3=(raw_r, raw_i), chan_order=held_order, chan_inv=held_inv,
            audio_dtype=audio_dtype)
        return tails, cstate, audioT, rssi

    def step_tmajor(params, state, re, im, i16):
        head = _halo_head(re, im, state.pfb_carry, h, comm)
        x = (re, im) if i16 else cx.CX(re, im)
        tails, (tr, ti) = channelize_fused.channelize_fused_c(
            plan, params.W_pfb, head, x,
            factors=channelizer._pick_factors(M), bf16_mxu=fast,
            out_layout="time")
        # reshard over the channel axis: [d, f_local, M] → [d, d·f_local,
        # M/d], channel shard c holding bins c·M/d …, in bin order
        tr = comm.all_to_all(tr, 1, 0)
        ti = comm.all_to_all(ti, 1, 0)
        os_carry = cx.CX(*(p[:, -ov:, :].permute(0, 2, 1)
                           .reshape(n_rows, ov) for p in (tr, ti)))
        kw = dict(audio_dtype=audio_dtype)
        if params.chain.W_tailpass is not None and (M // d) % 8 == 0:
            # the FIR tail reads the shards' planes as they lie
            kw.update(fir_x3=(tr, ti), chan_order=held_order,
                      chan_inv=held_inv)
        else:
            xT = cx.CX(*(p.movedim(0, 1).reshape(-1, n_rows)
                         for p in (tr, ti)))
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
        head = _halo_head(re, im, state.pfb_carry, h, comm)
        if i16:
            re, im = re.float() * I16_SCALE, im.float() * I16_SCALE
        # the next call's history is the input's tail, as the reference
        # takes it, whatever the channelizer returns ("stub" passes its
        # carry through)
        tails = cx.CX(re[..., -h:].contiguous(), im[..., -h:].contiguous())
        _, chans = wb.channelize_dispatch(cfg, params, head, cx.CX(re, im))
        # reshard: [d, M, f_local] → [d, M/d, d·f_local], i.e. this
        # process's [M/world, frames]
        chans = comm.all_to_all(chans, 0, 1).reshape(n_rows, -1)
        cstate, out = chain_mod.process_traced(ccfg, params.chain,
                                               state.chain, chans)
        audio = out.audio
        if cfg.time_major:
            audio = audio.T.to(audio_dtype).contiguous()
        return tails, cstate, audio, out.rssi

    step = {"planar": step_planar, "tmajor": step_tmajor,
            "fallback": step_fallback}[mp.tier]

    def to_bins(chain):
        """All rows in row order → the serial state (M rows, bin order)."""
        def one(v):
            full = torch.empty_like(v)
            full[state_rows] = v
            return full[:M]
        return _map_state(one, chain)

    def process_n(params, state, iqs):
        """N consecutive chunks, state threaded through; returns (state,
        audio tuple, RSSI of the last chunk)."""
        dev = params.W_pfb.device
        if dev != mesh.device:
            raise ValueError(f"params lie on {dev}, the mesh on "
                             f"{mesh.device}")
        if comm.world == 1:
            state = state._replace(chain=_map_state(pad0, state.chain))
        elif state.chain.agc.gain_db.shape[0] != n_rows:
            raise ValueError(f"across processes the state holds this "
                             f"process's {n_rows} rows "
                             f"(process.local_state), not "
                             f"{state.chain.agc.gain_db.shape[0]}")
        audios, rssi = [], None
        for iq in iqs:
            re, im, i16 = _as_shards(wb.coerce(iq, dev), d, cfg.chunk_in,
                                     comm)
            tails, cstate, audio, rssi = step(params, state, re, im, i16)
            last = cx.CX(*(comm.broadcast_last(t)[0] for t in tails))
            state = wb.WidebandState(pfb_carry=last, chain=cstate)
            audios.append(audio)
        if comm.world == 1 and C_pad != M:
            state = state._replace(
                chain=_map_state(lambda v: v[:M], state.chain))
            audios = [a[:, :M] for a in audios]
            rssi = rssi[:M]
        return state, tuple(audios), rssi

    def process(params, state, iq):
        """iq: [chunk_in] — CX / complex numpy / (re_i16, im_i16)."""
        st, audios, rssi = process_n(params, state, (iq,))
        return st, audios[0], rssi

    def gather_rows(t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every process's rows of an audio (dim 1, time-major; 0 for
        chan-major audio and the RSSI), the phantom rows dropped: what
        one process returns, in `channel_order`."""
        return comm.gather(t, dim).narrow(dim, 0, M)

    def local_state(state: wb.WidebandState) -> wb.WidebandState:
        """The form of the serial state (M rows, bin order) that this
        process passes: its rows, in row order (in one process the state
        itself)."""
        if comm.world == 1:
            return state
        return state._replace(chain=_map_state(lambda v: pad0(v)[my_rows],
                                               state.chain))

    def gather_state(state: wb.WidebandState) -> wb.WidebandState:
        """The serial wideband's state (M rows, bin order) from every
        process's rows."""
        if comm.world == 1:
            return state
        return state._replace(chain=to_bins(_map_state(
            lambda v: comm.gather(v, 0), state.chain)))

    process.process_n = process_n
    # audio/RSSI row → PFB bin: the planar order of the mesh's factoring on
    # the planar tier, bin order otherwise
    process.channel_order = order
    process.planar = planar
    process.planar_factors = mp.factors if planar else None
    process.tier = mp.tier
    process.rows = (comm.rank * n_rows, (comm.rank + 1) * n_rows)
    process.gather_rows = gather_rows
    process.local_state = local_state
    process.gather_state = gather_state
    return process


def make_params(cfg: wb.WidebandConfig, device=None,
                **kw) -> wb.WidebandParams:
    """The serial wideband's params (the mesh keeps no params of its
    own)."""
    return wb.make_params(cfg, device=device, **kw)


def init_state(cfg: wb.WidebandConfig, device=None) -> wb.WidebandState:
    """The serial wideband's zero stream state."""
    return wb.init_state(cfg, device=device)

