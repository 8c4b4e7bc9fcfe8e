"""The reference's demodulators, one file a mode, `<mode>.py` in lower
case, each found by the configuration's `deployment.mode`. A mode's file
has `PASSBAND`, the passband (low and high cut, Hz); `LEAVES`, the names
of the stream state it carries, each the path of the same leaf in the
program's chain state (`demod.dc_x`); `tables(dep, iq_rate)`;
`zero(M, device)`, the zero state as {leaf: float64 [M]}; and
`demod(tables, y, leaves)`, the passband-filtered channels y [M, n]
complex128 → (the signal the interpolator takes, [M, n] float64, the
leaves after the block)."""

from __future__ import annotations

import importlib


def load(mode: str):
    return importlib.import_module(f"sdrbench.reference.modes.{mode.lower()}")
