"""The program's own spans and host-sync counts, and their arithmetic
against the traced slice's device trace.

`supersdr_tpu_torch.utils.profiling` records spans (name, start and end in
Unix ns, parent index, chunk identifier) and counts blocking host↔device
crossings by chunk, only while a `torch.profiler` runs: after a traced run
they are the traced slice's own, read in the same process. A version of
the program that records none gives None here, and each metric that reads
them gives None.

`Trace.device` keeps its times in µs from a base that `sdrbench/trace.py`
does not keep. A device operation cannot start before the host call that
issued it began, so `base_ns` recovers the base from the program's launch
spans, each paired in order with its kernel's launches (each counted
kernel launches once a chunk: the launch check holds the program to it).
The estimate lies below the true base by the least launch-to-start
latency: the FIR tail's launch span starts 0-40 µs before its kernel
where the device waits for the host.

The trace's clock wanders against the host's by up to milliseconds over
seconds of a run (measured on the card: PERF.md §6), so one base
serves a traced replay slice (0.1 s) but not a live window (51 s).
`chunk_bases` gives each chunk a base of its own from its own launches
and, where the program fetches to the host (the live monitor), from its
fetches' copies: the listened row's starts a few µs after its span began.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

from sdrbench import roofline, trace

# a launch span → the roofline file of the kernel it launches
LAUNCHES = {"wideband.channelize": "channelize_fused",
            "chain.tail.launch": "chain_tail_fir"}
# spans that each copy one tensor to the host (trace name "Memcpy DtoH"),
# and how far outside a chunk's spans, on its launches' clock, its copies
# are looked for: more than that clock's error (the launch wrappers' host
# work, hundreds of µs), less than the time between chunks
FETCHES = ("monitor.rssi_fetch", "monitor.audio_fetch")
CHUNK_SLACK_US = 1000.0
# spans in which the host waits for a copy to or from the device
CROSSINGS = ("wideband.ingest", "monitor.rssi_fetch", "monitor.audio_fetch")


def recorded(ctx: dict):
    """(spans, host syncs by chunk) the program recorded in a traced run,
    or None where the run was not traced or the program recorded none."""
    if ctx.get("trace") is None:
        return None
    try:
        from supersdr_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    sp = profiling.spans()
    if not sp:
        return None
    return sp, profiling.host_syncs()


def roots(spans: list) -> list:
    return [s for s in spans if s.parent < 0]


def chunks(spans: list) -> list:
    """The chunk identifiers of the root spans, in order."""
    return sorted({s.chunk for s in roots(spans)})


def duration_ms(s) -> float:
    return (s.end_ns - s.start_ns) * 1e-6


def ms_by_chunk(spans: list, names) -> dict:
    """{chunk: ms inside spans of `names`} over every chunk of a root."""
    out = {c: 0.0 for c in chunks(spans)}
    for s in spans:
        if s.name in names:
            out[s.chunk] += duration_ms(s)
    return out


def median_by_chunk(spans: list, names) -> float | None:
    v = list(ms_by_chunk(spans, names).values())
    return statistics.median(v) if v else None


def syncs_per_chunk(spans: list, syncs: dict) -> int | None:
    """The host syncs each chunk counted, where every chunk counted the
    same; None where they differ or no chunk ran."""
    counts = {syncs.get(c, 0) for c in chunks(spans)}
    return counts.pop() if len(counts) == 1 else None


def launched(spans: list, device: list):
    """(launch spans, their kernel's launches), in order, for each kernel
    of LAUNCHES."""
    for span_name, kernel in LAUNCHES.items():
        name = roofline.kernel(kernel).KERNEL
        yield ([s for s in spans if s.name == span_name],
               [e for e in device if name in e.name])


def _bound(s, e) -> int:
    """What a span and the device operation it issued say of the base:
    at least the span's start less the operation's start, ns."""
    return s.start_ns - round(e.start * 1e3)


def _launch_pairs(spans: list, device: list) -> list | None:
    pairs = []
    for calls, kernels in launched(spans, device):
        if len(calls) != len(kernels):
            return None
        pairs += zip(calls, kernels)
    return pairs


def base_ns(spans: list, device: list) -> int | None:
    """The trace's base on the Unix clock, ns: the largest (launch span's
    start − its kernel's start) over every counted launch. None where no
    launch pairs, or a launch span and its kernel's launches differ in
    number."""
    pairs = _launch_pairs(spans, device)
    return max(_bound(s, e) for s, e in pairs) if pairs else None


def chunk_bases(spans: list, device: list) -> dict | None:
    """{chunk: its own base, ns}: the largest bound its launches and its
    fetches' copies give (`fetched`). None where `base_ns` pairs
    nothing."""
    pairs = _launch_pairs(spans, device)
    if not pairs:
        return None
    out: dict = {}
    for s, e in pairs:
        out[s.chunk] = max(out.get(s.chunk, _bound(s, e)), _bound(s, e))
    for s, e in fetched(spans, device, out):
        out[s.chunk] = max(out[s.chunk], _bound(s, e))
    return out


def fetched(spans: list, device: list, bases: dict) -> list:
    """[(fetch span, its copy to the host)]: each chunk's fetch spans in
    order with the copies that start within CHUNK_SLACK_US of the chunk's
    spans on its clock, where they are as many (a chunk whose copy is
    missing from the trace is left out)."""
    copies = sorted((e for e in device if "DtoH" in e.name),
                    key=lambda e: e.start)
    starts = [e.start for e in copies]
    by_chunk: dict = defaultdict(list)
    for s in spans:
        by_chunk[s.chunk].append(s)
    out = []
    for chunk, ss in by_chunk.items():
        fetches = [s for s in ss if s.name in FETCHES]
        if not fetches or chunk not in bases:
            continue
        lo = (min(s.start_ns for s in ss) - bases[chunk]) * 1e-3
        hi = (max(s.end_ns for s in ss) - bases[chunk]) * 1e-3
        i = bisect.bisect_left(starts, lo - CHUNK_SLACK_US)
        j = bisect.bisect_right(starts, hi + CHUNK_SLACK_US)
        if j - i == len(fetches):
            out += zip(fetches, copies[i:j])
    return out


def shifted_us(s, base: int | dict) -> tuple[float, float]:
    """A span's [start, end] on the trace's clock, µs, by one base or by
    its chunk's (`chunk_bases`)."""
    b = base[s.chunk] if isinstance(base, dict) else base
    return (s.start_ns - b) * 1e-3, (s.end_ns - b) * 1e-3


class Busy:
    """The device's busy intervals (merged), and how much of an interval
    they cover."""

    def __init__(self, device: list):
        self.union = trace.union(device)
        self.starts = [s for s, _ in self.union]

    def within(self, a: float, b: float) -> float:
        """µs of [a, b] in which some device operation runs."""
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        t = 0.0
        while i < len(self.union) and self.union[i][0] < b:
            s, e = self.union[i]
            t += max(0.0, min(e, b) - max(s, a))
            i += 1
        return t


def idle_in_s(spans: list, base: int | dict, device: list) -> float:
    """Seconds in which the host is inside one of `spans` (not nested in
    one another) and no device operation runs."""
    busy = Busy(device)
    t = 0.0
    for s in spans:
        a, b = shifted_us(s, base)
        t += (b - a) - busy.within(a, b)
    return t * 1e-6


def self_intervals(spans: list) -> list:
    """[(span, [(start_ns, end_ns), …])]: each span's interval less its
    children's."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent >= 0:
            kids[s.parent].append(s)
    out = []
    for i, s in enumerate(spans):
        parts, t = [], s.start_ns
        for c in sorted(kids[i], key=lambda c: c.start_ns):
            parts.append((t, c.start_ns))
            t = c.end_ns
        parts.append((t, s.end_ns))
        out.append((s, [(a, b) for a, b in parts if b > a]))
    return out


def self_ms_by_name(spans: list) -> dict:
    """{span name: its self time a chunk, ms} (a span's duration less its
    children's), the mean over the chunks of the root spans."""
    n = max(len(chunks(spans)), 1)
    out: dict = defaultdict(float)
    for s, parts in self_intervals(spans):
        out[s.name] += sum(b - a for a, b in parts) * 1e-6 / n
    return dict(out)


def clock(spans: list, device: list) -> int | dict | None:
    """The base to shift the spans by: each chunk's own where the program
    fetches to the host (every chunk then has a tight bound of its own),
    else one for the slice."""
    if any(s.name in FETCHES for s in spans):
        return chunk_bases(spans, device)
    return base_ns(spans, device)


def idle_by_span(spans: list, base: int | dict, device: list,
                 window_s: float) -> dict:
    """The slice's idle seconds split by the innermost span the host was
    in; idle time inside the observed part of the slice (its first span or
    device operation to its last) under no span is "outside the program",
    the rest of the slice "slice ends"."""
    busy = Busy(device)
    out: dict = defaultdict(float)
    for s, parts in self_intervals(spans):
        at = base[s.chunk] if isinstance(base, dict) else base
        for a, b in parts:
            a_us, b_us = (a - at) * 1e-3, (b - at) * 1e-3
            out[s.name] += ((b_us - a_us) - busy.within(a_us, b_us)) * 1e-6
    ranges = [shifted_us(s, base) for s in roots(spans)]
    ranges += [(e.start, e.end) for e in device]
    lo = min(a for a, _ in ranges)
    hi = max(b for _, b in ranges)
    idle_seen = ((hi - lo) - busy.within(lo, hi)) * 1e-6
    out["outside the program"] = idle_seen - sum(out.values())
    out["slice ends"] = window_s - (hi - lo) * 1e-6
    return dict(out)


def main(argv=None) -> int:
    """Run one cell traced, as `sdrbench.run --trace 1` does, and write
    what the program recorded beside the slice's device trace as JSON:
    the spans (name, start and end in Unix ns, parent, chunk), the host
    syncs by chunk, the device's operations (short names, µs), the
    driver's host spans, the per-layer metrics, the base `clock` gives,
    each span's self time a chunk and the slice's idle time by span."""
    import argparse
    import importlib
    import json

    import torch

    from sdrbench import check
    from sdrbench import run as R
    from sdrbench.system import SYSTEMS
    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    R.pin_to_one_core()
    spec = R.load_spec()
    wl, conf, traffic = R.find_cell(spec, args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = R.Cell(wl["name"], conf, traffic, args.seed, args.seconds, True,
                  device, check.load_limits(wl["name"]))
    driver = importlib.import_module(f"sdrbench.drivers.{traffic['driver']}")
    res = driver.run(cell, SYSTEMS["program"])
    ok, _ = res["readings"].verdict(cell.limits)
    tr = res["trace"]
    ctx = {"trace": tr, "conf": conf, "frames": traffic["frames"],
           "dispatch_ms": res.get("dispatch_ms")}
    rec = recorded(ctx)
    sp, syncs = rec if rec is not None else ([], {})
    base = clock(sp, tr.device) if sp else None
    out = {"workload": wl["name"], "seed": args.seed,
           "correct": ok and res.get("launches_ok", True),
           "card": R.power_limit(), "window_s": tr.window_s,
           "chunks": tr.chunks, "span_s": tr.span_s, "base_ns": base,
           "metrics": {m["name"]: R.metric_reader(m["name"])(ctx)
                       for m in spec["per_layer"] if R.applies(m, wl["name"])},
           "self_ms_a_chunk": self_ms_by_name(sp),
           "idle_s_by_span": (idle_by_span(sp, base, tr.device, tr.window_s)
                              if base is not None else None),
           "syncs": {str(k): v for k, v in syncs.items()},
           "spans": [list(s) for s in sp],
           "device": [[trace.short_name(e.name), e.start, e.end]
                      for e in tr.device]}
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps({k: out[k] for k in ("workload", "seed", "correct",
                                          "card", "metrics")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
