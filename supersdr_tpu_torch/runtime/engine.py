"""Stream engine: source → device chain → sink, with reconnect/backoff.

The host-side conductor replacing the reference's per-receiver RX thread
(`kiwi_sound.run`, utils_supersdr.py:1150-1186) and the headless
`KiwiWorker` reconnect loop (kiwi/worker.py:10-79):

  * pulls IQ blocks from a source iterator/callable
  * batches them into device-sized chunks and runs the jitted chain
  * pushes audio frames through the latency governor into a FrameBuffer
  * on source failure, reconnects with per-cause backoff
    (5 s server-close / 15 s busy, kiwi/worker.py:48-69) and a retry budget
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np

from supersdr_tpu_torch.runtime.governor import DriftCompensator, LatencyGovernor
from supersdr_tpu_torch.runtime.ring import FrameBuffer


class SourceBusy(Exception):
    """Source refused: try again later (maps KiwiTooBusyError)."""


class SourceClosed(Exception):
    """Source terminated: reconnect (maps KiwiServerTerminatedConnection)."""


@dataclass
class EngineConfig:
    buffer_frames: int = 10          # FULL_BUFF_LEN default (supersdr.py:30)
    connect_retries: int = 0         # 0 = unlimited (worker semantics)
    backoff_closed_s: float = 5.0
    backoff_busy_s: float = 15.0
    time_limit_s: float | None = None
    pipeline_depth: int = 0          # >0: keep N device dispatches in
                                     # flight (fetch block k-N while k
                                     # computes) — hides the host↔device
                                     # round trip at +N blocks of latency


class StreamEngine:
    """Runs `process(block) -> audio_frames` over a reconnecting source.

    source_factory: () -> iterator of IQ blocks (raises SourceBusy/
    SourceClosed/StopIteration); process: one device step; sink: receives
    ('audio', frame) items popped by the audio callback.
    """

    def __init__(self, source_factory: Callable[[], Iterator[np.ndarray]],
                 process: Callable[[np.ndarray], np.ndarray],
                 config: EngineConfig | None = None,
                 governor: LatencyGovernor | None = None,
                 drift: DriftCompensator | None = None,
                 clock: Callable[[], float] = None,
                 process_dispatch: Callable | None = None,
                 process_fetch: Callable | None = None):
        self.cfg = config or EngineConfig()
        self.source_factory = source_factory
        self.process = process
        # async split (pipeline_depth > 0): dispatch returns a device
        # handle, fetch materializes the audio — JAX's async dispatch
        # overlaps block k's device time with block k-1's readback
        self.process_dispatch = process_dispatch
        self.process_fetch = process_fetch
        self.buffer = FrameBuffer(self.cfg.buffer_frames)
        self.governor = governor
        self.drift = drift
        self.clock = clock or (lambda: time.monotonic() * 1000.0)
        self.terminate = False
        self.status = "idle"
        self.dropped_frames = 0
        self.reconnects = 0
        self.switch_failures = 0
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self._pending_factory: Callable[[], Iterator[np.ndarray]] | None = None

    def switch_source(self, factory: Callable[[], Iterator[np.ndarray]]
                      ) -> None:
        """Interactive server switching: swap in a new source factory; if
        connecting to it fails, automatically revert to the previous one
        (reference supersdr.py:743-796 semantics). Takes effect at the
        next block boundary."""
        self._pending_factory = factory
        self._wake.set()

    # ------------------------------------------------------------ control

    def start(self) -> "StreamEngine":
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def stop(self, join: bool = True) -> None:
        self.terminate = True
        self._wake.set()
        if join and self._thread is not None:
            self._thread.join(timeout=5)

    def _sleep(self, seconds: float) -> None:
        self._wake.wait(timeout=seconds)

    # ---------------------------------------------------------------- run

    def run(self) -> None:
        retries = self.cfg.connect_retries
        start_time = time.monotonic()
        while not self.terminate:
            switching_from = None
            if self._pending_factory is not None:
                switching_from = self.source_factory
                self.source_factory = self._pending_factory
                self._pending_factory = None
                self._wake.clear()
            try:
                source = self.source_factory()
            except SourceBusy:
                if switching_from is not None:
                    self._revert(switching_from)
                    continue
                self.status = "busy"
                self.reconnects += 1
                self._sleep(self.cfg.backoff_busy_s)
                continue
            except (SourceClosed, OSError):
                if switching_from is not None:
                    self._revert(switching_from)
                    continue
                self.status = "connect-failed"
                retries -= 1
                if self.cfg.connect_retries > 0 and retries <= 0:
                    break
                self._sleep(self.cfg.backoff_closed_s)
                continue
            self.status = "streaming"
            if self.reconnects > 0 and self.governor is not None:
                # a reconnect starts a fresh stream timeline
                self.governor.reset()
            try:
                self._pump(source)
                if self._pending_factory is not None:
                    continue  # switch requested: reconnect immediately
                break  # source exhausted cleanly
            except SourceBusy:
                self.status = "busy"
                self.reconnects += 1
                self._sleep(self.cfg.backoff_busy_s)
            except (SourceClosed, OSError):
                self.status = "reconnecting"
                self.reconnects += 1
                self._sleep(self.cfg.backoff_closed_s)
            if self.cfg.time_limit_s is not None and \
                    time.monotonic() - start_time > self.cfg.time_limit_s:
                break
        self.status = "stopped"

    def _revert(self, previous: Callable[[], Iterator[np.ndarray]]) -> None:
        """Failed switch: fall back to the previous server
        (supersdr.py:779-796)."""
        self.source_factory = previous
        self.switch_failures += 1
        self.status = "switch-failed-reverted"

    def _pump(self, source: Iterator[np.ndarray]) -> None:
        from collections import deque
        depth = self.cfg.pipeline_depth
        use_async = (depth > 0 and self.process_dispatch is not None
                     and self.process_fetch is not None)
        inflight: deque = deque()
        for block in source:
            if self.terminate or self._pending_factory is not None:
                return
            if self.drift is not None and self.drift.tick():
                # consume one extra block to absorb clock drift
                try:
                    next(source)
                except StopIteration:
                    pass
            if use_async:
                inflight.append(self.process_dispatch(block))
                if len(inflight) <= depth:
                    continue
                audio = self.process_fetch(inflight.popleft())
            else:
                audio = self.process(block)
            action = "buffer"
            if self.governor is not None:
                action = self.governor.on_frame(self.clock())
            if action == "drop":
                self.dropped_frames += 1
                continue
            self.buffer.put(np.asarray(audio), block=True, timeout=5.0)
        # drain the pipeline tail so no audio is lost at stream end
        while inflight and not self.terminate:
            audio = self.process_fetch(inflight.popleft())
            self.buffer.put(np.asarray(audio), block=True, timeout=5.0)

    # ------------------------------------------------------------ sink API

    def pop_audio(self, timeout: float | None = 1.0) -> np.ndarray | None:
        """Called from the audio callback; None → play silence
        (late/underrun, utils:1106-1115)."""
        if self.governor is not None and self.governor.late:
            return None
        return self.buffer.get(timeout=timeout)
