"""The comparison that decides `correct`.

Four numbers, each the worst over everything a run compares, each held
against the cell's limit in `sdrbench/limits/<cell>.json`:

  audio_err    the worst channel's ‖audio − ref‖ / ‖ref‖ over a chunk
  planes_err   the worst channel's relative error in the passband history
               the stream carries (the last n_taps − 1 channelizer
               outputs), the channelizer's planes as the state holds them
  rssi_err_db  the largest |RSSI − ref| in dB
  state_err    the worst state leaf's ‖state − ref‖ / ‖ref‖: the PFB
               history, the interpolator's history and each leaf of the
               demodulator's (AM: the DC blocker's two samples, the AGC's
               peak and gain), all channels at once; the squelch gate's
               leaves (its 0/1 state and its gain, both in [0, 1]) read
               their largest |state − ref| instead, so one channel whose
               gate decided otherwise reads 1

An answer or a state that never came, or holds a NaN, reads infinite.
Besides, every timed chunk has to launch each kernel the configuration
counts (`launches`) as often as it says.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from sdrbench.reference import squelch
from sdrbench.reference.pipeline import RefState

NAMES = ("audio_err", "planes_err", "rssi_err_db", "state_err")
LIMITS_DIR = Path(__file__).resolve().parent / "limits"


def load_limits(cell: str) -> dict:
    with open(LIMITS_DIR / f"{cell}.json") as f:
        limits = json.load(f)
    missing = set(NAMES) - set(limits)
    if missing:
        raise ValueError(f"limits of {cell} lack {sorted(missing)}")
    return limits


def _finite(v: float) -> float:
    """NaN and ±inf read as +inf: worse than any limit."""
    return v if math.isfinite(v) else math.inf


def rel_rows(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows of ‖got − ref‖ / ‖ref‖ (rows: the first axis)."""
    got, ref = got.to(ref.dtype), ref
    num = torch.linalg.vector_norm(got - ref, dim=tuple(range(1, ref.ndim)))
    den = torch.linalg.vector_norm(ref, dim=tuple(range(1, ref.ndim)))
    return _finite(float((num / den.clamp_min(1e-300)).max()))


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    num = float(torch.linalg.vector_norm(got.to(ref.dtype) - ref))
    return _finite(num / max(float(torch.linalg.vector_norm(ref)), 1e-300))


def abs_max(got: torch.Tensor, ref: torch.Tensor) -> float:
    return _finite(float((got.to(ref.dtype) - ref).abs().max()))


def state_errs(got: RefState, ref: RefState) -> tuple[float, float]:
    """(planes_err, state_err) of a state against the reference's."""
    leaves = [rel(got.pfb, ref.pfb), rel(got.interp, ref.interp)]
    leaves += [(abs_max if k in squelch.LEAVES else rel)(got.leaves[k], v)
               for k, v in ref.leaves.items()]
    return rel_rows(got.os, ref.os), max(leaves)


def launches(system, before: dict | None, chunks: int
             ) -> tuple[bool, list[str]]:
    """(each counted wrapper launched `launches_per_chunk` times a chunk
    over `chunks` timed chunks, lines for standard error); nothing to
    hold where the system counts nothing (off the card, the control)."""
    if before is None:
        return True, []
    after = system.launches()
    grew = {k: after[k] - before[k] for k in before}
    want = {k: n * chunks for k, n in system.launches_per_chunk.items()}
    return grew == want, [f"launches in the window: {grew} for {chunks} "
                          f"chunks, due {want}"]


class Readings:
    """The worst reading of each number over a run."""

    def __init__(self):
        self.worst = {n: 0.0 for n in NAMES}
        self.counts = {n: 0 for n in NAMES}

    def add(self, name: str, value: float) -> None:
        self.worst[name] = max(self.worst[name], _finite(value))
        self.counts[name] += 1

    def verdict(self, limits: dict) -> tuple[bool, dict]:
        """(every number compared and within its limit, {name: [value,
        limit]})."""
        out = {n: [self.worst[n], limits[n]] for n in NAMES}
        ok = all(self.counts[n] > 0 and self.worst[n] <= limits[n]
                 for n in NAMES)
        return ok, out
