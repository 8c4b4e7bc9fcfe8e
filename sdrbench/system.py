"""What a cell runs: the program under test, or the control in its place.

Both take a configuration file and a chunk size and give the drivers one
interface: `init_state()`, `step(state, (re_i16, im_i16)) -> (state,
audio [frames·L, C] time-major, rssi [C, 1])`, `ref_state(state)`, the
stream state as the reference holds it (bins in order, float64), a plain
function that holds nothing of the system; `row_bins`, the bin of each
output row by the benchmark's own rule; `cfg`, the program's own
configuration; and `launches()`, the counted kernel launches so far
(None where nothing is counted) against `launches_per_chunk`.

The program is the configuration's `program`, `sdrbench/programs/
<program>.py`; the control is the plain reference rounded to the
precision below the configuration's (`reference/precision.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from sdrbench import programs
from sdrbench.reference import pipeline, precision


def program(conf: dict, frames: int, device):
    return programs.load(conf).Program(conf, frames, device)


def _ref_state(st) -> pipeline.RefState:
    return st


class Control:
    kind = "control"
    launches_per_chunk: dict = {}

    def __init__(self, conf: dict, frames: int, device):
        self.device = torch.device(device)
        self.frames = frames
        self.cfg = programs.load(conf).config(conf, frames)
        self.tables = pipeline.make_tables(conf["deployment"], self.device)
        self.rnd = precision.rounder(conf["control_precision"])
        self.row_bins = np.arange(conf["deployment"]["n_chan"])
        self.ref_state = _ref_state

    def init_state(self):
        return pipeline.zero_state(self.tables, self.device)

    def step(self, state, iq16):
        # a squelch gate decides on the control's own (rounded) RSSI
        st, audio, rssi, _ = pipeline.step(
            self.tables, state, iq16[0].to(self.device),
            iq16[1].to(self.device), self.frames, self.rnd)
        return st, audio.T, rssi

    def launches(self):
        return None


SYSTEMS = {"program": program, "control": Control}
