"""`replay`: a recorded band capture played back in a closed loop.

Set-up makes the capture on the device from the seed (a ring of
`ring_chunks` consecutive chunks), builds the system and runs
`warmup_chunks` chunks through it on a state of their own. The window
then starts from the zero state and calls `step` once a chunk on ring
chunk i mod ring_chunks, the state threaded through, with no host
synchronise until the host clock has passed `seconds`; it ends on a
synchronise. `input_msps` is every input sample of the chunks it ran over
the window's time. With `--trace 1`, chunks trace_first_chunk to
trace_first_chunk + trace_chunks − 1 run under the profiler, a
synchronise on each side.

What is compared, once the window has closed (the reference in float64,
from the same int16 chunks):
  * chunks 0 to first_chunks − 1, from the zero state through the
    reference's own carried state: the carry between chunks;
  * `late_chunks` chunks drawn from the seed, uniformly over every chunk
    the window runs after those (a reservoir: the window's length is
    known only once it has closed), and the window's last chunk, each
    from the state the program entered it with (the reference cannot
    follow thousands of chunks inside a run): their audio, their RSSI
    and the state they hand on;
  * the audio of `rows` channels drawn from the seed (all where there
    are fewer), half of them carriers, in each of those chunks, and of
    every channel in the last one, whose whole output the loop holds
    anyway; the RSSI and the state of every channel.
Every timed chunk has to launch each kernel the configuration counts.
Where the deployment has a squelch gate, the reference takes its decision
for a channel in a chunk from the program's RSSI wherever its own lies
within the cell's `rssi_err_db` limit of a threshold (the edge rule of
`reference/squelch.py`); a note gives how many did, how near the others
came, and how many gates opened and shut in the compared chunks.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from sdrbench import check, signal
from sdrbench.reference import pipeline, squelch


class Reservoir:
    """k items drawn uniformly from a stream of unknown length, with
    Li's algorithm L: random draws only where an item is taken (some
    k·ln(n/k) of n), none for the items between."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = k, rng
        self.w = 1.0
        self.next = k - 1
        self._advance()

    def _u(self) -> float:
        return 1.0 - self.rng.random()          # in (0, 1]

    def _advance(self) -> None:
        """Draw the next item to take: skip a geometric number of items."""
        self.w *= math.exp(math.log(self._u()) / self.k)
        skip = 0 if self.w >= 1.0 else math.floor(
            math.log(self._u()) / math.log1p(-self.w))
        self.next += skip + 1

    def slot(self, j: int) -> int | None:
        """The slot the stream's item j (from 0, in order) replaces, or
        None where it is not taken."""
        if j < self.k:
            return j
        if j != self.next:
            return None
        self._advance()
        return int(self.rng.integers(self.k))


def run(cell, make_system) -> dict:
    tr, conf, device = cell.traffic, cell.conf, cell.device
    dep = conf["deployment"]
    M, frames = dep["n_chan"], tr["frames"]
    n_ring = tr["ring_chunks"]
    cap = signal.make_capture(tr["signal"], M, dep["fs_in"], n_ring, frames,
                              cell.seed, device)
    ring = [(cap.re[i], cap.im[i]) for i in range(n_ring)]
    sys_ = make_system(conf, frames, device)
    st = sys_.init_state()
    for i in range(tr["warmup_chunks"]):
        st, audio, rssi = sys_.step(st, ring[i % n_ring])
    del st, audio, rssi

    ck = tr["check"]
    rng = np.random.default_rng([cell.seed, 1])
    n_rows = min(ck["rows"], M)
    half = min(n_rows // 2, len(cap.carrier_bins))
    noise_bins = np.setdiff1d(np.arange(M), cap.carrier_bins)
    bins = np.concatenate([rng.choice(cap.carrier_bins, half, replace=False),
                           rng.choice(noise_bins, n_rows - half,
                                      replace=False)])
    bin_row = torch.as_tensor(np.argsort(sys_.row_bins), device=device)
    rows = bin_row[torch.as_tensor(bins, device=device)]
    first, n_late = ck["first_chunks"], ck["late_chunks"]
    late = Reservoir(n_late, np.random.default_rng([cell.seed, 3]))
    t_lo = tr["trace_first_chunk"]
    t_hi = t_lo + tr["trace_chunks"]
    tracer = None
    if cell.trace:
        from sdrbench.trace import Tracer
        tracer = Tracer(device)
    launches0 = sys_.launches()

    # chunk → (state in, sampled audio, rssi, state out)
    kept_first, kept_late = {}, {}
    cell.opened()
    t0 = time.perf_counter()
    st = sys_.init_state()
    i = 0
    while True:
        if tracer is not None and i == t_lo:
            tracer.start()
        st_in = st
        st, audio, rssi = sys_.step(st, ring[i % n_ring])
        if i < first:
            kept_first[i] = (st_in, audio[:, rows], rssi, st)
        else:
            j = late.slot(i - first)
            if j is not None:
                kept_late[j] = (i, st_in, audio[:, rows], rssi, st)
        i += 1
        if tracer is not None and i == t_hi:
            tracer.stop(t_hi - t_lo)
        if i >= first + n_late and (tracer is None or i >= t_hi) \
                and time.perf_counter() - t0 >= cell.seconds:
            break
    cell.sync()
    elapsed = time.perf_counter() - t0
    out = cell.closed()
    last = (i - 1, st_in, audio[:, bin_row], rssi, st)
    del audio
    out["attempted"] = i
    out["failed"] = 0
    out["e2e"]["input_msps"] = i * M * frames / elapsed / 1e6
    out["notes"] = [f"window: {i} chunks in {elapsed:.6f} s; clipped input "
                    f"samples {cap.clipped}"]
    out["launches_ok"], lines = check.launches(sys_, launches0, i)
    out["notes"] += lines
    out["notes"].append("late chunks compared: " + " ".join(
        str(v[0]) for v in sorted(kept_late.values(), key=lambda v: v[0])))
    if tracer is not None:
        out["trace"] = tracer.collect()

    # the reference, once the program's parameters are freed
    to_ref = sys_.ref_state
    del sys_, st, st_in
    cell.free()
    tables = pipeline.make_tables(dep, device)
    margin = cell.limits["rssi_err_db"]
    rd = check.Readings()
    ref_bins = torch.as_tensor(bins, device=device)
    made = squelch.NONE

    def compare(state, k, got_audio, got_rssi, got_state, ref_rows):
        """Chunk k from `state` against the program's; the reference's
        state after it."""
        nonlocal made
        rssi = got_rssi[bin_row]
        ref = pipeline.step(tables, state, *ring[k % n_ring], frames,
                            edge_rssi=rssi, margin=margin)
        made = squelch.merge(made, ref.gate)
        rd.add("audio_err", check.rel_rows(got_audio.T, ref.audio[ref_rows]))
        rd.add("rssi_err_db", check.abs_max(rssi[:, 0], ref.rssi[:, 0]))
        p, s = check.state_errs(to_ref(got_state), ref.state)
        rd.add("planes_err", p)
        rd.add("state_err", s)
        return ref.state

    rs = pipeline.zero_state(tables, device)
    for k in range(first):
        _, got, rssi, st_out = kept_first.pop(k)
        rs = compare(rs, k, got, rssi, st_out, ref_bins)
    for k, st_in, got, rssi, st_out in kept_late.values():
        compare(to_ref(st_in), k, got, rssi, st_out, ref_bins)
    k, st_in, got, rssi, st_out = last
    compare(to_ref(st_in), k, got, rssi, st_out, slice(None))
    if tables.sq is not None:
        out["notes"].append(
            f"squelch: {made.edge} channel-chunks decided at an edge, on the "
            f"program's RSSI (within {margin} dB of a threshold); the "
            f"nearest other decision {made.clear_db} dB from one; "
            f"{made.opened} gates opened and {made.shut} shut")
    out["readings"] = rd
    return out
