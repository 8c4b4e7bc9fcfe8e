"""Pipeline parallelism: the wideband pipeline split into two stages.

Counterpart of `supersdr_tpu/parallel/pipeline.py`, the optional "PP"
axis: the 2-stage GPipe schedule. Stage 0 runs the channelizer on
microbatch i while stage 1 runs the receiver chains on microbatch i − 1;
the inter-stage payload (the channels as float planes packed into an
audio-shaped buffer) is handed over by `collectives.send_next`, one hop a
step. M microbatches take M + 1 steps: one fill bubble (stage 1 idle) and
one drain bubble (stage 0 idle).

The two stages are shards of one device here, run one after the other
within a step. A stage in its bubble does nothing: the reference runs its
chain stage on the zero payload of the fill step, which advances the
chain's stream state by a chunk of zeros (ROADMAP queue 3); the port's
chain state sees the microbatches alone, so the pipeline equals the serial
wideband with the AGC on as well as off.
"""

from __future__ import annotations

import torch

from supersdr_tpu_torch.ops import channelizer, cx
from supersdr_tpu_torch.parallel import collectives
from supersdr_tpu_torch.parallel.sharded_wideband import Mesh
from supersdr_tpu_torch.parallel.sharded_wideband import \
    make_mesh as _make_mesh
from supersdr_tpu_torch.runtime import chain as chain_mod
from supersdr_tpu_torch.runtime import wideband as wb


def make_mesh(device=None) -> Mesh:
    """The pipeline's mesh: two stage shards on `device`."""
    return _make_mesh(2, device)


def build(cfg: wb.WidebandConfig, mesh: Mesh):
    """The 2-stage pipelined wideband. Returns process(params, state,
    iq_microbatches) with iq_microbatches [M, chunk_in] (CX, complex
    tensor or complex numpy): (state, audio [M, n_chan, chunk_per_chan·L]),
    microbatch i's audio realigned to index i. Params and state are the
    serial wideband's, on `mesh.device`."""
    if mesh.n_shards != 2:
        raise ValueError("the 2-stage pipeline uses exactly 2 shards")
    plan = wb.pfb_plan(cfg)
    ccfg = cfg.chain_cfg
    n_chan = cfg.n_chan
    frames = cfg.chunk_per_chan
    L, M_ = ccfg.resample_LM
    out_len = frames * L // M_
    # the payload: the channels as float planes in the audio-shaped buffer
    # (2·frames floats ≤ out_len when L/M ≥ 2)
    if out_len < 2 * frames:
        raise ValueError("audio upsample < 2x: enlarge the payload packing")

    def process(params: wb.WidebandParams, state: wb.WidebandState,
                iq_microbatches):
        dev = params.W_pfb.device
        if dev != mesh.device:
            raise ValueError(f"params lie on {dev}, the mesh on "
                             f"{mesh.device}")
        mbs = cx.as_cx(iq_microbatches, device=dev)
        n_mb = mbs.re.shape[0]
        pfb_carry = torch.complex(state.pfb_carry.re, state.pfb_carry.im)
        cstate = state.chain
        inflight = None
        audios = []
        for step in range(n_mb + 1):
            # each stage's output this step: [stage, n_chan, out_len]
            out = torch.zeros(2, n_chan, out_len, device=dev)
            if step < n_mb:                                  # stage 0
                pfb_carry, chans = channelizer.channelize_c(
                    plan, params.W_pfb, pfb_carry,
                    torch.complex(mbs.re[step], mbs.im[step]))
                out[0, :, :frames] = chans.real
                out[0, :, frames:2 * frames] = chans.imag
            if step > 0:                                     # stage 1
                chans = torch.complex(inflight[:, :frames],
                                      inflight[:, frames:2 * frames])
                cstate, o = chain_mod.process_traced(ccfg, params.chain,
                                                     cstate, chans)
                out[1] = o.audio
                audios.append(o.audio)
            # stage 0's payload to stage 1 for the next step
            inflight = collectives.send_next(out)[1]
        new_state = wb.WidebandState(
            pfb_carry=cx.CX(pfb_carry.real.contiguous(),
                            pfb_carry.imag.contiguous()),
            chain=cstate)
        return new_state, torch.stack(audios)

    return process
