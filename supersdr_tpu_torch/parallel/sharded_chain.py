"""Mesh-sharded receiver chains: channel × time parallelism.

Counterpart of `supersdr_tpu/parallel/sharded_chain.py`: the same chain as
`runtime.chain`, over a ('chan', 'time') mesh.

  chan  virtual receivers; no communication: it is the batch axis.
  time  one long capture split into contiguous shards along the sample
        axis. The coupling between shards is small and explicit:
          overlap-save filter history   halo of n_taps − 1 samples
          resampler history             halo of per − 1 samples
          NBFM phase memory             halo of 1 sample
          DC blocker, AGC recurrences   two-level scans (2·D scalars each)
        so a shard's traffic is O(n_taps + D) whatever its length.

The body is written once over `[n_chan, D_local, n_local]`, so one launch
of each op serves every shard of this process; whatever crosses shards
goes through the mesh's transport (`parallel/collectives.py`), in this
process or, with a process group, across processes (each process holding
D_local = D / world consecutive time shards). The sharded program equals
the serial chain on the whole capture up to float rounding, and the
stream state entering and leaving a call is the serial chain's (the last
global shard's, on every process), so consecutive calls chain as the
serial version does.
"""

from __future__ import annotations

import numpy as np
import torch

from supersdr_tpu_torch.device import default_device
from supersdr_tpu_torch.ops import agc as agc_ops
from supersdr_tpu_torch.ops import cx
from supersdr_tpu_torch.ops import demod as demod_ops
from supersdr_tpu_torch.ops import (fir_matmul, mixer, overlap_save,
                                    resample, smeter)
from supersdr_tpu_torch.ops import squelch as squelch_ops
from supersdr_tpu_torch.parallel import collectives
from supersdr_tpu_torch.parallel.mesh import TIME_AXIS, Mesh
from supersdr_tpu_torch.runtime import chain as chain_mod
from supersdr_tpu_torch.runtime.chain import (ChainConfig, ChainOutput,
                                              ChainParams, ChainState)

SHARD_AXIS = -2


def _last(t: torch.Tensor) -> torch.Tensor:
    """This process's last time shard's value of a per-shard state leaf
    [C, D_local, …] (the transport's `replicate` then hands every process
    the last global shard's)."""
    return t[:, -1]


def _sharded_body(cfg: ChainConfig, n_time: int, params: ChainParams,
                  state: ChainState, iq: cx.CX, comm
                  ) -> tuple[ChainState, ChainOutput]:
    """iq: CX [C, D_local·chunk], this process's shards of the call. Every
    op below runs on [C, D_local, chunk] with (C, D_local) as its batch;
    the state leaves are [C] and seed global shard 0."""
    plan = cfg.os_plan
    D = n_time // comm.world
    C = iq.re.shape[0]
    n_rows = cfg.chunk // cfg.os_block
    x = torch.complex(iq.re, iq.im).reshape(C, D, cfg.chunk)
    t_idx = comm.shard_index(x)[:, 0].to(torch.float32)

    # 0. noise blanker: the median is the shard's own, as the reference's
    if cfg.blanker_enabled:
        x = squelch_ops.apply_blanker(params.blanker, x)

    # 1. NCO with a phase base per time shard: global shard t starts at
    #    t·chunk
    inc = params.nco.block_inc[..., None]
    phase0 = torch.remainder(state.phase[..., None] + t_idx * inc, 1.0)
    nco = mixer.NCOParams(ramp=params.nco.ramp[..., None, :], block_inc=inc)
    _, x = mixer.mix(nco, phase0, x)
    phase_out = torch.remainder(state.phase
                                + float(n_time) * params.nco.block_inc, 1.0)

    # 2. passband; the history is the left neighbour's tail, and the
    #    incoming stream state on global shard 0
    ov = plan.overlap
    if ov:
        head = comm.left_halo(x, ov, head0=state.os_carry)
    else:
        head = x[..., :0]
    if cfg.passband_impl == "matmul":
        _, yc = fir_matmul.fir_matmul_stream_c(
            cfg.fir_plan, params.W_pass, cx.CX(head.real, head.imag),
            cx.CX(x.real, x.imag))
        y = torch.complex(yc.re, yc.im)
    else:
        y = overlap_save.overlap_save_batch_c(
            plan, torch.complex(params.H_pass.re, params.H_pass.im), head,
            x.reshape(C, D, n_rows, cfg.os_block)).reshape(C, D, cfg.chunk)
    tail = x[:, -1, cfg.chunk - ov:]
    os_carry = cx.CX(tail.real.contiguous(), tail.imag.contiguous())
    rssi = smeter.rssi_db(y.reshape(C, D, n_rows, cfg.os_block))

    # 3-4. demod + AGC, their recurrences exact across the shards
    mode = cfg.mode.upper()
    dstate, audio = demod_ops.demodulate(
        cfg.mode, state.demod, y, cfg.iq_rate, max_dev_hz=cfg.max_dev_hz,
        shard_axis=SHARD_AXIS, comm=comm)
    if mode == "AM":
        dstate = dstate._replace(dc_x=_last(dstate.dc_x),
                                 dc_y=_last(dstate.dc_y))
    elif mode == "NBFM":
        dstate = dstate._replace(last_sample=cx.CX(
            *(_last(p) for p in dstate.last_sample)))
    astate, audio = agc_ops.apply(params.agc, state.agc, audio,
                                  hang_window=cfg.hang_window,
                                  decimation=cfg.agc_decimation,
                                  shard_axis=SHARD_AXIS, comm=comm)
    astate = agc_ops.AGCState(*(_last(v) for v in astate))

    # the squelch gates each shard on its own RSSI from the incoming gate
    # state (frame-granular, as the reference's: not the serial
    # whole-chunk gate)
    sq_state = state.squelch
    if cfg.squelch_enabled:
        sq_in = squelch_ops.SquelchState(*(v[..., None]
                                           for v in state.squelch))
        sq_state, audio = squelch_ops.apply_squelch(
            params.squelch, sq_in, audio, torch.mean(rssi, dim=-1))
        sq_state = squelch_ops.SquelchState(*(_last(v) for v in sq_state))

    # 5. resample; the history halo is in the audio domain
    if mode == "IQ":
        out_audio = cx.CX(audio.real.reshape(C, -1),
                          audio.imag.reshape(C, -1))
        icarry = state.interp_carry
    else:
        audio = audio.float()
        if cfg.is_rational:
            # the rational resampler carries zero-stuffed-domain history:
            # rebuild the neighbour's stuffed tail from its last
            # ceil(history / L) audio samples (the stuffing phase is
            # block-aligned: chunk % M == 0)
            rplan = cfg.rational_plan
            k = -(-rplan.history // rplan.L)
            halo_in = comm.left_halo(audio, k)
            up = audio.new_zeros(C, D, k * rplan.L)
            up[..., :: rplan.L] = halo_in
            ihead = up[..., k * rplan.L - rplan.history:]
            if comm.rank == 0:                  # global shard 0
                ihead[:, 0] = state.interp_carry
            icarry, out_audio = resample.rational_resample_block(
                rplan, params.P_interp, ihead, audio)
        else:
            iplan = cfg.interp_plan
            ihead = comm.left_halo(audio, iplan.history,
                                   head0=state.interp_carry)
            icarry, out_audio = resample.interpolate(
                iplan, params.P_interp, ihead, audio, cfg.resample_impl)
        icarry = _last(icarry)
        out_audio = out_audio.reshape(C, -1)
    new_state = comm.replicate(ChainState(
        phase=phase_out, os_carry=os_carry, demod=dstate, agc=astate,
        interp_carry=icarry, squelch=sq_state))
    return new_state, ChainOutput(
        audio=out_audio, rssi=rssi.reshape(C, -1),
        baseband=cx.CX(y.real.reshape(C, -1), y.imag.reshape(C, -1)))


def build(cfg: ChainConfig, mesh: Mesh, halo_impl: str = "rdma"):
    """The sharded chain for `mesh`; cfg.chunk is the per-shard length.
    Returns process(params, state, iq) where
      iq    : [n_chan, chunk · d_local], this process's time shards of the
              call (all n_time of them in one process; with a process
              group rank r's are global shards r·d_local …, e.g. from
              `ingest.make_global_iq(...).flatten(-2)`), CX, complex tensor
              or complex numpy
      state : leaves with a leading [n_chan] axis, the same on every process
    and the returned state is the stream state at the end of the call
    (the last global time shard's, on every process), usable for the next
    call; the output is this process's shards. Everything runs on
    `mesh.device`, where the params and the state must lie. halo_impl:
    "rdma" exchanges halos with the halo kernel (`ops/cuda/halo.py`) on a
    CUDA device, "ppermute" with plain slice copies; on the CPU both are
    the plain version."""
    n_time = mesh.shape[TIME_AXIS]
    d_local = mesh.d_local
    if cfg.passband_impl == "matmul_real":
        raise ValueError("passband_impl='matmul_real' is serial-only for "
                         "now (its rotation params are passband-dependent "
                         "structure); use 'matmul' on the mesh")
    if halo_impl not in collectives.HALO_IMPLS:
        raise ValueError(f"halo_impl must be one of "
                         f"{collectives.HALO_IMPLS}")
    comm = mesh.comm.using(halo_impl)

    def process(params: ChainParams, state: ChainState, iq
                ) -> tuple[ChainState, ChainOutput]:
        dev = params.P_interp.device
        if default_device(dev) != mesh.device:
            raise ValueError(f"params lie on {dev}, the mesh on "
                             f"{mesh.device}")
        iq = cx.as_cx(iq, device=dev)
        if iq.re.ndim != 2 or iq.re.shape[-1] != cfg.chunk * d_local:
            raise ValueError(f"iq must be [n_chan, {cfg.chunk}·{d_local}], "
                             f"got {tuple(iq.re.shape)}")
        if iq.re.shape[0] % mesh.n_chan:
            raise ValueError(f"{iq.re.shape[0]} receivers do not split "
                             f"over {mesh.n_chan} channel shards")
        return _sharded_body(cfg, n_time, params, state, iq, comm)

    return process


def make_params(cfg: ChainConfig, n_chan: int,
                freq_offsets_hz: np.ndarray | float = 0.0, device=None,
                **kwargs) -> ChainParams:
    """Per-channel params for the sharded chain: the offsets broadcast to
    [n_chan]; `device` defaults as the mesh's does (`make_mesh`: the
    current CUDA device); everything else as `chain.make_params`."""
    offs = np.broadcast_to(np.asarray(freq_offsets_hz, np.float64), (n_chan,))
    return chain_mod.make_params(cfg, freq_offset_hz=offs,
                                 device=default_device(device), **kwargs)


def init_state(cfg: ChainConfig, n_chan: int, device=None) -> ChainState:
    """Stream state for n_chan receivers, on `device` (default as the
    mesh's)."""
    return chain_mod.init_state(cfg, (n_chan,),
                                device=default_device(device))
