"""The programs under test, one file each, `<program>.py`, found by a
configuration's `program`. A program's file has `config(conf, frames)`,
the program's own configuration object, and `Program(conf, frames,
device)`, the system the drivers run (see `sdrbench/system.py`)."""

from __future__ import annotations

import importlib


def load(conf: dict):
    return importlib.import_module(f"sdrbench.programs.{conf['program']}")
