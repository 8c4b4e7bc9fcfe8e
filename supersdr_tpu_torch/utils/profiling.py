"""Tracing and per-block timing (the reference's `utils/profiling.py`).

  * `trace(...)` — context manager around `torch.profiler` for device
    traces: the host's ops and, when a CUDA card is present, its kernels
    and copies, written as one Chrome trace (JSON) into `logdir`, viewable
    in Perfetto (ui.perfetto.dev) or chrome://tracing, and in TensorBoard's
    profiler plugin
  * `BlockTimer` — streaming per-stage wall-time stats (EWMA + percentiles)
    for the host loop: source wait, device step, sink push
  * `log` — structured logging setup (one line per event, key=value)

`BlockTimer`, `ThroughputMeter` and `get_logger` are the reference's.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from collections import defaultdict, deque
from dataclasses import dataclass

import numpy as np


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
    `channelize_mma_kernel<…>` and `chain_tail_fir_kernel<…>`."""
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
    prof.start()
    try:
        yield logdir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()


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
