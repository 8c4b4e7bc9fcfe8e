"""Quick memories: 10-deep cyclic bank of (freq, mode, Δlow, Δhigh).

Behavior of the reference `memory` class (
utils_supersdr.py:351-391) with JSON persistence instead of pickle (same
merge-and-dedup on save)."""

from __future__ import annotations

import json
from collections import deque
from pathlib import Path

DEFAULT_FILE = "supersdr_tpu.memory.json"


class MemoryBank:
    DEPTH = 10

    def __init__(self, path: str | Path = DEFAULT_FILE):
        self.path = Path(path)
        self.mem_list: deque = deque([], self.DEPTH)
        self.index = 0

    def write_mem(self, freq_khz: float, radio_mode: str,
                  delta_low: float, delta_high: float) -> None:
        self.mem_list.append((round(freq_khz, 3), radio_mode,
                              delta_low, delta_high))

    def recall_mem(self):
        """Cyclic recall (next entry each call); None when empty."""
        if not self.mem_list:
            return None
        self.index = (self.index + 1) % len(self.mem_list)
        return self.mem_list[self.index]

    def reset_all_mem(self) -> None:
        self.mem_list = deque([], self.DEPTH)

    def save_to_disk(self) -> None:
        current = list(self.mem_list)
        self.load_from_disk()
        merged = {tuple(m) for m in self.mem_list} | {tuple(m) for m in current}
        self.mem_list = deque(sorted(merged), self.DEPTH * 100)
        self.path.write_text(json.dumps([list(m) for m in self.mem_list]))

    def load_from_disk(self) -> None:
        try:
            data = json.loads(self.path.read_text())
            self.mem_list = deque([tuple(m) for m in data], self.DEPTH * 100)
        except (OSError, ValueError):
            self.mem_list = deque([], self.DEPTH)

    def __len__(self) -> int:
        return len(self.mem_list)
