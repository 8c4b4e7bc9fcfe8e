"""The device trace of a run's traced slice, and the arithmetic on it.

`Tracer` runs `torch.profiler` with CUDA activity alone (host operations
are not recorded, so the host runs at its untraced pace) over a slice of
the window that the driver opens with `start()` and closes with `stop()`,
each after a synchronise; the slice's length is taken on the host's clock
between the two. The driver may also note host spans (`span_s`), such as
each traced chunk's push. `collect()` exports the Chrome trace under
TMPDIR, reads the device's operations back and deletes the file. Device
times are in the trace's clock, microseconds.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from typing import NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Event(NamedTuple):
    name: str
    start: float    # µs
    end: float


class Trace(NamedTuple):
    device: list    # [Event] kernels, copies and sets, by start
    window_s: float  # the slice's length on the host's clock
    chunks: int     # chunks the slice ran
    span_s: list    # host spans the driver noted, seconds


class Tracer:
    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        self._device = device
        acts = [ProfilerActivity.CUDA]
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        # the profiler's first start in a process sets up its tracing:
        # paid here, in set-up, not in the traced slice
        with profile(activities=acts):
            torch.ones(1, device=device).sum()
        torch.cuda.synchronize(device)
        self._prof = profile(activities=acts)
        self.chunks = 0
        self.span_s: list = []
        self._t0 = self.window_s = 0.0

    def start(self) -> None:
        torch.cuda.synchronize(self._device)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self, chunks: int) -> None:
        torch.cuda.synchronize(self._device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.chunks = chunks

    def collect(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="sdrbench_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return Trace(device=device_events(events), window_s=self.window_s,
                     chunks=self.chunks, span_s=list(self.span_s))


def device_events(events: list) -> list:
    out = [Event(e.get("name", ""), float(e["ts"]),
                 float(e["ts"]) + float(e["dur"]))
           for e in events
           if e.get("ph") == "X" and "dur" in e
           and e.get("cat") in DEVICE_CATS]
    return sorted(out, key=lambda e: e.start)


def union(events: list) -> list:
    """Merged [start, end] intervals covered by the events."""
    out: list = []
    for s, e in sorted((ev.start, ev.end) for ev in events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(tr: Trace) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in union(tr.device)) * 1e-6


def short_name(name: str, width: int = 80) -> str:
    """A kernel's name without `void`, its template and argument lists."""
    n = name.removeprefix("void ")
    for ch in "<(":
        i = n.find(ch)
        if i > 0:
            n = n[:i]
    return n[:width]


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of
    the slice by the operation the device waited for (each gap named by
    the operation that ended it), each list the `top` largest; the slice's
    ends (its synchronises, the host's first launches) are one entry."""
    ops: dict = {}
    for e in tr.device:
        k = short_name(e.name)
        ops[k] = ops.get(k, 0.0) + (e.end - e.start) * 1e-6
    gaps: dict = {}
    prev = None
    for e in tr.device:
        if prev is not None and e.start > prev:
            k = f"before {short_name(e.name)}"
            gaps[k] = gaps.get(k, 0.0) + (e.start - prev) * 1e-6
        prev = e.end if prev is None else max(prev, e.end)
    if tr.device:
        inner = (prev - tr.device[0].start) * 1e-6
        gaps["slice ends: synchronise and first launch"] = max(
            0.0, tr.window_s - inner)
    return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:top]}
