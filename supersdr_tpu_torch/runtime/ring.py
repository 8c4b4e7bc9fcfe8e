"""Bounded audio frame buffer between the RX/compute thread and the
audio-sink callback — the role of `kiwi_sound.audio_buffer`
(queue.Queue(FULL_BUFF_LEN), utils_supersdr.py:917-918)
plus fill-level introspection for the HUD (utils:1462-1467)."""

from __future__ import annotations

import queue
import threading

import numpy as np


class FrameBuffer:
    def __init__(self, depth: int):
        self.depth = max(1, depth)
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self.underruns = 0
        self.overruns = 0
        self._lock = threading.Lock()

    def put(self, frame: np.ndarray, block: bool = True,
            timeout: float | None = None) -> bool:
        try:
            self._q.put(frame, block=block, timeout=timeout)
            return True
        except queue.Full:
            with self._lock:
                self.overruns += 1
            return False

    def get(self, block: bool = True, timeout: float | None = None
            ) -> np.ndarray | None:
        try:
            return self._q.get(block=block, timeout=timeout)
        except queue.Empty:
            with self._lock:
                self.underruns += 1
            return None

    def qsize(self) -> int:
        return self._q.qsize()

    @property
    def fill(self) -> float:
        return self._q.qsize() / self.depth

    def drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return
