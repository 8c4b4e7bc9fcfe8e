"""Tracing and per-block timing (the reference's `utils/profiling.py`).

  * `trace(...)` — context manager around `torch.profiler` for device
    traces: the host's ops and, when a CUDA card is present, its kernels
    and copies, written as one Chrome trace (JSON) into `logdir`, viewable
    in Perfetto (ui.perfetto.dev) or chrome://tracing, and in TensorBoard's
    profiler plugin
  * `BlockTimer` — streaming per-stage wall-time stats (EWMA + percentiles)
    for the host loop: source wait, device step, sink push
  * `log` — structured logging setup (one line per event, key=value)
  * `span` / `count_sync` / `count_plan` / `count_gate` / `count_graph` —
    the program's own spans, host↔device crossings, plan builds, squelch
    gates and held-graph replays, recorded only while a `torch.profiler`
    runs (below)

`BlockTimer`, `ThroughputMeter` and `get_logger` are the reference's.

**Spans.** `with span("wideband.process"): ...` marks a layer boundary of
the program. While a `torch.profiler` runs (the flag torch sets for it,
`torch.autograd.profiler._is_profiler_enabled`), each span is recorded in
memory as a `Span`: its name, start and end on the Unix clock in ns
(`time.time_ns()`, the clock of a profiler trace's `ts` plus its
`baseTimeNanoseconds`; on a card the trace's device times wander against
it by up to milliseconds over seconds, so hold spans against them chunk
by chunk), the index of the span that was open around it
(-1 for a root) and a chunk identifier, which a root span draws anew
unless given one and its children inherit. `count_sync()` counts one
blocking host↔device crossing under the innermost open span's chunk.
`count_plan(built)` records whether the chunk found its fixed plan held
or built (part of) it (`utils/held.py`): a chunk that built anything
counts as built. `count_gate(gain_in, open_out)` keeps, under the chunk,
what a squelch gate met, and `gates()` counts it on the device: the
channels settled open (entered at gain 1 and decided open: its audio
passes unchanged), settled shut (entered at gain 0 and decided shut: its
audio is zeros) and moving (the rest). `count_graph(replayed)` records
whether the chunk replayed a held CUDA graph (`runtime/stream_graph.py`)
or ran otherwise (eager, or a capture first). `spans()`, `host_syncs()`,
`plans()`, `gates()`, `graphs()` read what was recorded (`gates()` reads
the device once), `clear_spans()` empties all five. With no profiler
running a span costs one flag read: nothing is recorded and nothing is
counted.

`device_span(name, like)` is a span whose device work can be found in a
CUDA-only device trace, which holds no host events: where the tensor
`like` lies on a CUDA device it launches an empty marker kernel
(`MARKER_KERNEL`, torch's spin kernel for zero cycles) on the current
stream as it opens and as it closes, so the operations the span launched
are those between its two markers in the stream's order. Off a profiler
it is `span`'s one flag read.
`trace` writes the spans of its block into the Chrome trace it writes, as
complete events of category `program_span`.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_CATEGORY = "program_span"
# the name the device trace gives `device_span`'s marker kernel
MARKER_KERNEL = "spin_kernel"


class Span(NamedTuple):
    name: str
    start_ns: int          # Unix clock, ns (`time.time_ns()`)
    end_ns: int | None     # None while the span is open
    parent: int            # index in `spans()` of the enclosing span, or -1
    chunk: int             # the chunk the span's work belongs to


class _Recorder:
    """The spans and crossings of the process. A span is a position in
    five parallel lists (name, start, end, parent, chunk: strings and
    integers, which the garbage collector does not track, so a long
    traced run does not slow its collections), and the open spans are a
    stack of positions. The chunk path records from one thread: spans
    opened by two threads at once would nest into each other. Used as the
    context manager of an open span: leaving it closes the innermost."""

    def __init__(self):
        self.chunks = 0
        self.clear()

    def clear(self) -> None:
        self.names: list = []
        self.starts: list = []
        self.ends: list = []
        self.parents: list = []
        self.chunk_ids: list = []
        self.stack: list = []
        self.syncs: dict = defaultdict(int)
        self.plans: dict = {}
        self.gates: dict = {}
        self.graphs: dict = {}

    def open(self, name: str, chunk: int | None) -> "_Recorder":
        st = self.stack
        if st:
            parent = st[-1]
            chunk = self.chunk_ids[parent]
        else:
            parent = -1
            if chunk is None:
                self.chunks += 1
                chunk = self.chunks
        st.append(len(self.names))
        self.names.append(name)
        self.ends.append(None)
        self.parents.append(parent)
        self.chunk_ids.append(chunk)
        self.starts.append(time.time_ns())
        return self

    def chunk(self) -> int | None:
        return self.chunk_ids[self.stack[-1]] if self.stack else None

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        t = time.time_ns()
        if self.stack:
            self.ends[self.stack.pop()] = t
        return False

    def spans(self) -> list:
        return [Span(*r) for r in zip(self.names, self.starts, self.ends,
                                      self.parents, self.chunk_ids)]


class _MarkedSpan:
    """A span on a CUDA device, bracketed by a marker kernel at each end
    on the current stream."""

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device

    def __enter__(self):
        _RECORDER.open(self.name, None)
        _mark(self.device)

    def __exit__(self, *exc):
        _mark(self.device)
        return _RECORDER.__exit__(*exc)


def _mark(device: torch.device) -> None:
    with torch.cuda.device(device):
        torch.cuda._sleep(0)


class _NoSpan:
    """The span handed out while no profiler runs: does nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_RECORDER = _Recorder()
_NO_SPAN = _NoSpan()


def span(name: str, chunk: int | None = None):
    """A context manager around one layer's work (see the module's
    docstring). A root span takes `chunk` as its chunk identifier where
    given, else a new one; a nested span takes its parent's."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RECORDER.open(name, chunk)


def device_span(name: str, like: torch.Tensor):
    """`span` whose device work is marked in the stream where `like` lies
    on a CUDA device (see the module's docstring); a nested span takes
    its parent's chunk."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    if like.device.type != "cuda":
        return _RECORDER.open(name, None)
    return _MarkedSpan(name, like.device)


def recording() -> bool:
    """True while spans and crossings are recorded (a profiler runs)."""
    return _autograd_profiler._is_profiler_enabled


def current_chunk() -> int | None:
    """The chunk identifier of the innermost open span; None where none
    is open or no profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return _RECORDER.chunk()


def count_sync() -> None:
    """Count one blocking host↔device crossing (a copy the host waits
    for) under the innermost open span's chunk."""
    if _autograd_profiler._is_profiler_enabled:
        _RECORDER.syncs[_RECORDER.chunk()] += 1


def count_plan(built: bool) -> None:
    """Record, under the innermost open span's chunk, that the chunk found
    its plan held (False) or built some of it (True)."""
    if _autograd_profiler._is_profiler_enabled:
        plans = _RECORDER.plans
        chunk = _RECORDER.chunk()
        plans[chunk] = plans.get(chunk, False) or built


def count_graph(replayed: bool) -> None:
    """Record, under the innermost open span's chunk, that the chunk
    replayed a held graph (True) or did not (False: it ran eager, or
    captured its graph first)."""
    if _autograd_profiler._is_profiler_enabled:
        graphs = _RECORDER.graphs
        chunk = _RECORDER.chunk()
        graphs[chunk] = graphs.get(chunk, True) and replayed


def count_gate(gain_in: torch.Tensor, open_out: torch.Tensor) -> None:
    """Keep, under the innermost open span's chunk, the gain each channel
    entered a squelch gate with and the gate it decided, for `gates()` to
    count: nothing is launched here, since a kernel's first launch inside
    a traced slice loads its module and holds the device idle."""
    if _autograd_profiler._is_profiler_enabled:
        _RECORDER.gates.setdefault(_RECORDER.chunk(), []).append(
            (gain_in, open_out))


def spans() -> list[Span]:
    """Every span recorded since the last `clear_spans()`, in the order
    they opened (the index is what `Span.parent` refers to)."""
    return _RECORDER.spans()


def host_syncs() -> dict:
    """Blocking host↔device crossings counted since the last
    `clear_spans()`, by chunk identifier."""
    return dict(_RECORDER.syncs)


def plans() -> dict:
    """{chunk identifier: True where the chunk built (some of) its plan,
    False where it found it held} since the last `clear_spans()`."""
    return dict(_RECORDER.plans)


def graphs() -> dict:
    """{chunk identifier: True where the chunk replayed a held graph,
    False where it did not} since the last `clear_spans()`."""
    return dict(_RECORDER.graphs)


def _met(gain_in: torch.Tensor, open_out: torch.Tensor) -> torch.Tensor:
    """[settled open, settled shut, moving] channels of one gate."""
    settled_open = (gain_in == 1) & (open_out == 1)
    settled_shut = (gain_in == 0) & (open_out == 0)
    return torch.stack([settled_open, settled_shut,
                        ~(settled_open | settled_shut)]).sum(-1)


def gates() -> dict:
    """{chunk identifier: (settled open, settled shut, moving)} channels
    the squelch gates met since the last `clear_spans()`, counted on the
    device and read in one copy."""
    g = _RECORDER.gates
    if not g:
        return {}
    counts = torch.stack([sum(_met(*m) for m in met)
                          for met in g.values()]).tolist()
    return {c: tuple(n) for c, n in zip(g, counts)}


def clear_spans() -> None:
    """Forget every recorded span, crossing, plan, gate and graph
    record."""
    _RECORDER.clear()


def _write_spans(path: str, first: int) -> None:
    """Add the spans recorded from index `first` on to the Chrome trace at
    `path`, as complete events of category SPAN_CATEGORY on the clock of
    the file's `baseTimeNanoseconds`."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), threading.get_native_id()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": SPAN_CATEGORY, "name": s.name, "pid": pid,
         "tid": tid, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"chunk": s.chunk, "parent": s.parent - first
                  if s.parent >= first else -1}}
        for s in spans()[first:] if s.end_ns is not None)
    with open(path, "w") as f:
        json.dump(doc, f)


def get_logger(name: str = "supersdr_tpu", level: int = logging.INFO
               ) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)
    return logger


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a device trace around the enclosed block; yields `logdir`
    (default: `supersdr_tpu_torch_trace` under the temporary directory).

    The trace is written when the block ends, as
    `<host>_<pid>.<ns>.pt.trace.json` in `logdir` (torch's TensorBoard
    naming): CPU activity always, CUDA activity (kernels, copies) when a
    card is present. Kernels appear under their own names, e.g.
    `channelize_mma_kernel<…>` and `chain_tail_fir_kernel<…>`; the
    program's spans of the block (`span`) as events of category
    `program_span`, on the same clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(),
                              "supersdr_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=torch.profiler.tensorboard_trace_handler(
                       logdir))
    before = set(trace_files(logdir))
    prof.start()
    first = len(_RECORDER.names)
    try:
        yield logdir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        for path in set(trace_files(logdir)) - before:
            _write_spans(path, first)


def trace_files(logdir: str) -> list[str]:
    """The Chrome traces `trace` wrote into `logdir`, oldest first."""
    names = [n for n in os.listdir(logdir) if n.endswith(".pt.trace.json")]
    return sorted((os.path.join(logdir, n) for n in names),
                  key=os.path.getmtime)


class BlockTimer:
    """Per-stage streaming timing stats for the host pipeline loop."""

    def __init__(self, window: int = 512):
        self.window = window
        self._samples: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self._open: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def stats(self, name: str) -> dict:
        s = np.asarray(self._samples[name])
        if len(s) == 0:
            return {"n": 0}
        return {"n": len(s), "mean_ms": float(s.mean() * 1e3),
                "p50_ms": float(np.percentile(s, 50) * 1e3),
                "p95_ms": float(np.percentile(s, 95) * 1e3),
                "max_ms": float(s.max() * 1e3)}

    def report(self) -> str:
        lines = []
        for name in sorted(self._samples):
            st = self.stats(name)
            if st["n"]:
                lines.append(f"{name}: n={st['n']} mean={st['mean_ms']:.2f}ms "
                             f"p50={st['p50_ms']:.2f}ms p95={st['p95_ms']:.2f}ms "
                             f"max={st['max_ms']:.2f}ms")
        return "\n".join(lines)


@dataclass
class ThroughputMeter:
    """Samples/sec EWMA for the HUD."""
    alpha: float = 0.1
    rate: float = 0.0
    _last: float | None = None

    def update(self, n_samples: int) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = n_samples / max(now - self._last, 1e-9)
            self.rate = (1 - self.alpha) * self.rate + self.alpha * inst \
                if self.rate else inst
        self._last = now
        return self.rate
