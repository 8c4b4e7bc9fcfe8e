"""`live`: a band monitor fed at the air's own rate, in an open loop.

A chunk is `frames` samples of every channel, so it is due every
frames / (fs_in / n_chan) seconds of air, whether or not the chunks
before it have finished. Set-up makes `ring_chunks` consecutive chunks on
the device from the seed, copies them to pinned host memory (the radio
driver's hand-over) and warms a `MonitorCore` up on chunks of its own.
The window runs floor(seconds / period) chunks through a fresh core: at
its due time chunk i (ring chunk i mod ring_chunks, an sc16 pair in
pinned memory) goes through `MonitorCore.push`, then `selected_audio()`
fetches the listened channel, a carrier's channel drawn from the seed and
selected by its frequency. A chunk's latency runs from its due time to
that fetch's return; a chunk later than its own air time is `failed`
(the listener hears a dropout). The generator's lateness (how long after
its due time a chunk went in) is reported beside.

The host waits out each chunk's due time busy, so the core that runs the
receiver stays awake between chunks. With `--trace 1` the whole window
runs under the profiler (started before the window opens, stopped after
it closes), each chunk's push and fetch is noted as a host span, and the
host time inside the receiver's process call is read for every chunk.

What is compared, once the window has closed: the reference runs the
whole stream from the zero state, in blocks of `ref_block_chunks` chunks,
and every chunk's listened audio, every chunk's RSSI table (the monitor's
smoothing applied to the reference's RSSI), the last chunk's audio of
every channel (fetched row by row through `selected_audio()` after the
window) and the state after the last chunk are held against it. Every
timed chunk has to launch each kernel the configuration counts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sdrbench import check, signal
from sdrbench.reference import design, pipeline


def _monitor(sys_, params=None):
    from supersdr_tpu_torch.apps.monitor import MonitorCore
    if sys_.kind == "program":
        return MonitorCore(sys_.cfg, params=params or sys_.params,
                           device=sys_.device)

    def control_fn(_params, state, iq):
        st, audio, rssi = sys_.step(state, iq)     # audio time-major
        return st, audio if sys_.cfg.time_major else audio.T, rssi
    core = MonitorCore(sys_.cfg, params=params, process_fn=control_fn,
                       channel_order=sys_.row_bins, device=sys_.device)
    core.state = sys_.init_state()
    return core


def _wait_until(t: float) -> None:
    while time.perf_counter() < t:
        pass


def _fetch_row(core, row: int) -> np.ndarray:
    core.select_row(row)
    return core.selected_audio()


def due_times(t_open: float, seconds: float, period: float) -> np.ndarray:
    """The due time of every chunk of a window opened at `t_open`: the
    first one period later, then one a period, as many as `seconds`
    holds whole."""
    return t_open + period * np.arange(1, int(seconds / period) + 1)


def run(cell, make_system) -> dict:
    tr, conf, device = cell.traffic, cell.conf, cell.device
    dep = conf["deployment"]
    if "squelch" in dep:
        # the gate decides on each chunk's raw RSSI, which the monitor's
        # smoothed table does not give for the edge rule (`replay` does)
        raise ValueError("the live driver does not judge a squelch gate")
    M, frames = dep["n_chan"], tr["frames"]
    n_ring = tr["ring_chunks"]
    period = frames * M / dep["fs_in"]
    cap = signal.make_capture(tr["signal"], M, dep["fs_in"], n_ring, frames,
                              cell.seed, device)
    pin = device.type == "cuda"
    host = [tuple(p.cpu().pin_memory() if pin else p.cpu()
                  for p in (cap.re[i], cap.im[i])) for i in range(n_ring)]
    carriers = cap.carrier_bins
    del cap
    sys_ = make_system(conf, frames, device)
    warm = _monitor(sys_)
    for i in range(tr["warmup_chunks"]):
        warm.push(host[i % n_ring])
        warm.selected_audio()
    rng = np.random.default_rng([cell.seed, 2])
    listened = int(rng.choice(carriers))
    freq = design.channel_freqs(M, dep["fs_in"])[listened]
    core = _monitor(sys_, params=warm.params)
    del warm
    core.select_freq(freq)
    n_chunks = len(due_times(0.0, cell.seconds, period))
    tracer = dispatch = None
    if cell.trace:
        from sdrbench.trace import Tracer
        tracer = Tracer(device)
        dispatch = []
        inner = core.process_fn

        def timed(params, state, iq):
            t = time.perf_counter()
            out = inner(params, state, iq)
            dispatch.append(time.perf_counter() - t)
            return out
        core.process_fn = timed
    launches0 = sys_.launches()

    audio, tables_rssi, lat, late = [], [], [], []
    if tracer is not None:
        tracer.start()
    cell.opened()
    for i, due in enumerate(due_times(time.perf_counter(), cell.seconds,
                                      period)):
        _wait_until(due)
        t_in = time.perf_counter()
        core.push(host[i % n_ring])
        a = core.selected_audio()
        t_out = time.perf_counter()
        late.append(t_in - due)
        lat.append(t_out - due)
        audio.append(a)
        tables_rssi.append(core.rssi_rows)
        if tracer is not None:
            tracer.span_s.append(t_out - t_in)
    cell.sync()
    out = cell.closed()
    if tracer is not None:
        tracer.stop(n_chunks)
    lat_ms = np.asarray(lat) * 1e3
    late_ms = np.asarray(late) * 1e3
    q = np.percentile
    out["attempted"] = n_chunks
    out["failed"] = int((lat_ms > period * 1e3).sum())
    out["e2e"]["latency_p50_ms"] = float(q(lat_ms, 50))
    out["e2e"]["latency_p95_ms"] = float(q(lat_ms, 95))
    out["notes"] = [
        f"window: {n_chunks} chunks due every {period * 1e3:.6f} ms; "
        f"latency ms p5/25/50/75/90/95/99/max " + " ".join(
            f"{v:.4f}" for v in (*q(lat_ms, (5, 25, 50, 75, 90, 95, 99)),
                                 lat_ms.max())) + f"; failed {out['failed']}",
        f"generator late: p50 {q(late_ms, 50):.6f} p95 {q(late_ms, 95):.6f} "
        f"max {late_ms.max():.6f} ms; listened bin {listened} at "
        f"{freq:.1f} Hz, row {core.selected}"]
    out["launches_ok"], lines = check.launches(sys_, launches0, n_chunks)
    out["notes"] += lines
    if tracer is not None:
        out["trace"] = tracer.collect()
        out["dispatch_ms"] = [d * 1e3 for d in dispatch]

    # every channel's audio of the last chunk, through the same fetch
    last_rows = np.stack([_fetch_row(core, r) for r in range(M)])

    # the reference over the whole stream, once the program is freed
    to_ref = sys_.ref_state
    got_state = to_ref(core.state)
    ewma = core.ewma
    rows_bins = sys_.row_bins
    del core, sys_
    cell.free()
    tables = pipeline.make_tables(dep, device)
    rd = check.Readings()
    block = tr["check"]["ref_block_chunks"]
    rs = pipeline.zero_state(tables, device)
    smooth = np.full(M, -120.0)
    for b0 in range(0, n_chunks, block):
        ks = range(b0, min(n_chunks, b0 + block))
        re = torch.cat([host[k % n_ring][0] for k in ks]).to(device)
        im = torch.cat([host[k % n_ring][1] for k in ks]).to(device)
        rs, r_audio, r_rssi, _ = pipeline.step(tables, rs, re, im, frames)
        r_sel = r_audio[listened].reshape(len(ks), -1)
        r_rssi = r_rssi.cpu().numpy()
        for j, k in enumerate(ks):
            rd.add("audio_err", check.rel_rows(
                torch.as_tensor(audio[k], device=device)[None],
                r_sel[j][None]))
            smooth = (1.0 - ewma) * smooth + ewma * r_rssi[:, j]
            got = np.empty(M)
            got[rows_bins] = tables_rssi[k]
            rd.add("rssi_err_db", float(np.abs(got - smooth).max()))
    bin_row = np.argsort(rows_bins)
    rd.add("audio_err", check.rel_rows(
        torch.as_tensor(last_rows[bin_row], device=device),
        r_audio.reshape(M, len(ks), -1)[:, -1]))
    p, s = check.state_errs(got_state, rs)
    rd.add("planes_err", p)
    rd.add("state_err", s)
    out["readings"] = rd
    return out
