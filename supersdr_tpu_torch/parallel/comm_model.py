"""Collective-traffic accounting for the sharded chain and the sharded
wideband pipeline.

Counterpart of `supersdr_tpu/parallel/comm_model.py`. The traffic a time
shard of the chain receives a call is O(n_taps + D) samples whatever its
length, so compute grows with the chunk while communication does not; the
wideband pipeline adds one volume collective, the all_to_all reshard.
`chain_comm_model` and `wideband_comm_model` are the analytic counts;
`parallel/collectives.traffic` counts the same bytes as the pipelines run,
and the tests hold the two equal. The reference also reads the bytes off
the compiled HLO of its sharded programs (`collective_bytes_from_hlo`);
the port has no HLO, and `collectives.traffic`, which every byte between
shards passes through, takes that role of ground truth. The reference
charges 8 bytes a channel for the neighbour sample in every mode; this
model charges what the mode moves (NBFM one complex sample, AM one float,
the others nothing), since it is held to the counted bytes.

The α-β projection takes its link numbers as arguments. The default rate
is NVLink's on an H100 SXM, 450 GB/s each way (NVIDIA's data sheet); the
latency of a collective between cards has not been measured and has no
default.
"""

from __future__ import annotations

import math

NVLINK_GBPS = 450.0     # H100 SXM NVLink, each way (data sheet)


def chain_comm_model(cfg, n_time: int, n_chan_local: int = 1) -> dict:
    """Bytes one time shard receives a call of the sharded chain
    (`parallel/sharded_chain.py`), for `n_chan_local` receivers. Complex
    samples count 8 bytes (two float32 planes)."""
    mode = cfg.mode.upper()
    halos = n_chan_local * (cfg.n_taps - 1) * 8     # filter history
    if mode != "IQ":                                # resampler history
        if cfg.is_rational:
            rplan = cfg.rational_plan
            halos += n_chan_local * -(-rplan.history // rplan.L) * 4
        else:
            halos += n_chan_local * cfg.interp_plan.history * 4
    if mode == "NBFM":                              # previous sample
        halos += n_chan_local * 8
    elif mode == "AM":
        halos += n_chan_local * 4
    # scan summaries: D × (a, b) a scan; the DC block (AM), the AGC's
    # peak tracker and its attack smoother
    n_scans = 3 if mode == "AM" else 2
    summaries = n_scans * n_time * 2 * 4 * n_chan_local
    if cfg.hang_enabled:                            # hang window context
        w = cfg.hang_window
        if cfg.agc_decimation > 1:
            w = max(1, w // cfg.agc_decimation)
        halos += n_chan_local * (w - 1) * 4
    return {"halo_bytes": halos, "summary_bytes": summaries,
            "total_bytes": halos + summaries}


def wideband_comm_model(cfg, d: int, i16: bool = False,
                        planar_waste_max: float | None = None) -> dict:
    """Bytes one shard receives a chunk of the sharded wideband pipeline
    (`parallel/sharded_wideband.py`) on `d` shards, on the tier and
    factoring its `build` picks: the PFB history halo (int16 planes when
    the chunk is int16, `i16`), the all_to_all reshard (the one volume
    collective) and the broadcast of the last shard's PFB tail. On the
    planar tier the all_to_all moves the raw [n1_pad, f_local, n2] planes,
    two real planes in the coupling type (bf16 on the fast profile),
    phantom planes included; elsewhere a [n_chan, f_local] complex64
    buffer (two float32 planes on the time-major tier). Also the number of
    collectives a chunk (a halo of both planes is one)."""
    from supersdr_tpu_torch.parallel import sharded_wideband as sw
    from supersdr_tpu_torch.runtime import wideband as wb
    mp = sw.plan_mesh(cfg, d, planar_waste_max)
    plan = wb.pfb_plan(cfg)
    halo = plan.history * (4 if i16 else 8)
    pad_frac = 0.0
    if mp.tier == "planar":
        n1, n2, n1_pad = mp.factors
        bpp = (2 if (cfg.chan_precision == "default"
                     and cfg.passband_precision == "default") else 4)
        a2a = n1_pad * n2 * mp.f_local * 2 * bpp * (d - 1) // d
        pad_frac = (n1_pad * n2 - cfg.n_chan) / cfg.n_chan
    else:
        a2a = cfg.n_chan * mp.f_local * 8 * (d - 1) // d
    carry = plan.history * 8 if d > 1 else 0
    n_coll = (1 + (1 if mp.tier == "fallback" else 2)
              + (2 * math.ceil(math.log2(d)) if d > 1 else 0))
    return {"halo_bytes": halo, "all_to_all_bytes": a2a,
            "carry_bytes": carry, "planar": mp.tier == "planar",
            "tier": mp.tier, "pad_frac": pad_frac, "n_collectives": n_coll,
            "total_bytes": halo + a2a + carry}


def scaling_efficiency(compute_s_per_chunk: float, comm_bytes: int,
                       link_gbps: float = NVLINK_GBPS, overlap: float = 0.0
                       ) -> float:
    """Projected efficiency = compute / (compute + (1 − overlap)·comm),
    bandwidth only; `scaling_efficiency_ab` adds the latency term that
    dominates small exchanges."""
    comm_s = comm_bytes / (link_gbps * 1e9)
    return compute_s_per_chunk / (compute_s_per_chunk
                                  + (1.0 - overlap) * comm_s)


def comm_time_ab(n_collectives: int, comm_bytes: int, alpha_s: float,
                 link_gbps: float = NVLINK_GBPS, hops: int = 1) -> float:
    """α-β estimate: each collective pays hops·α of launch and propagation
    latency, plus bytes over the link rate. The chain's exchanges are a
    few KB, so the α term dominates."""
    return n_collectives * hops * alpha_s + comm_bytes / (link_gbps * 1e9)


def scaling_efficiency_ab(compute_s_per_chunk: float, n_collectives: int,
                          comm_bytes: int, alpha_s: float,
                          link_gbps: float = NVLINK_GBPS, hops: int = 1,
                          overlap: float = 0.0) -> float:
    """Latency-aware projected efficiency (α-β). `n_collectives` is the
    count `collectives.traffic` keeps for a call: it does not grow with
    the chunk, so efficiency improves with chunk size."""
    comm_s = comm_time_ab(n_collectives, comm_bytes, alpha_s, link_gbps,
                          hops)
    return compute_s_per_chunk / (compute_s_per_chunk
                                  + (1.0 - overlap) * comm_s)
