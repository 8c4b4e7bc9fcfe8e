"""Collective-traffic accounting for the time-sharded chain.

Counterpart of the chain half of `supersdr_tpu/parallel/comm_model.py`.
The traffic a time shard receives a call is O(n_taps + D) samples whatever
its length, so compute grows with the chunk while communication does not.
`chain_comm_model` is the analytic count; `parallel/collectives.traffic`
counts the same bytes as the chain runs, and the tests hold the two equal.
The reference charges 8 bytes a channel for the neighbour sample in every
mode; this model charges what the mode moves (NBFM one complex sample, AM
one float, the others nothing), since it is held to the counted bytes.

The α-β projection takes its link numbers as arguments. The default rate
is NVLink's on an H100 SXM, 450 GB/s each way (NVIDIA's data sheet); the
latency of a collective between cards has not been measured and has no
default.
"""

from __future__ import annotations

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
