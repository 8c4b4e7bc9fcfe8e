"""The receiver's squelch gate (KiwiSDR's `SET squelch`), on the audio of
each channel, as set out in a configuration's `deployment.squelch` block
{"thresh_db", "hyst_db", "ramp_samples"}: the block turns the gate on.

Each chunk, from the chunk's own RSSI (dB, the reference's calibrated and
floored value), the gate opens at `thresh_db` and closes below
`thresh_db − hyst_db`, and holds between the two:

    open' = clamp(open + [rssi ≥ thresh] − [rssi < thresh − hyst], 0, 1)

Across the chunk's audio the gain ramps linearly from the gain carried in
toward open', 1 / ramp_samples a sample at the IQ rate, so
1 / (ramp_samples · L) an audio sample at L audio samples an IQ sample,
clamped between where it starts and its target; the gain carried out is
the ramp's value at the chunk's last audio sample. A stream starts open,
at gain 1.

The gate is a step in the RSSI: where the reference's RSSI lies within
`margin` dB of either threshold, a system whose RSSI is right to that
margin may decide either way. There the decision is taken from the
system's own RSSI (`edge_rssi`), and everywhere else from the
reference's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

LEAVES = ("squelch.open_", "squelch.gain")


class SquelchTables(NamedTuple):
    thresh_db: float
    close_db: float         # thresh_db − hyst_db
    slope: float            # gain a sample at the audio rate


class Decisions(NamedTuple):
    """Of the gate's decisions over a block: how many were taken at an
    edge, from the system's RSSI; the nearest the reference's RSSI came to
    a threshold in the others (dB; inf where there were none); and how
    many opened a shut gate and shut an open one."""
    edge: int
    clear_db: float
    opened: int
    shut: int


NONE = Decisions(0, math.inf, 0, 0)


def tables(sq: dict, upsample: int) -> SquelchTables:
    """From a configuration's `squelch` block, for audio at `upsample`
    samples an IQ sample."""
    return SquelchTables(thresh_db=float(sq["thresh_db"]),
                         close_db=float(sq["thresh_db"] - sq["hyst_db"]),
                         slope=1.0 / (max(sq["ramp_samples"], 1) * upsample))


def zero(M: int, device) -> dict:
    f = dict(dtype=torch.float64, device=device)
    return {"squelch.open_": torch.ones(M, **f),
            "squelch.gain": torch.ones(M, **f)}


def merge(a: Decisions, b: Decisions) -> Decisions:
    return Decisions(a.edge + b.edge, min(a.clear_db, b.clear_db),
                     a.opened + b.opened, a.shut + b.shut)


def decide(t: SquelchTables, open_: torch.Tensor, rssi: torch.Tensor
           ) -> torch.Tensor:
    """The gate after a chunk of RSSI `rssi` [M] dB (1 open, 0 shut)."""
    opens = (rssi >= t.thresh_db).double()
    closes = (rssi < t.close_db).double()
    return torch.clamp(open_ + opens - closes, 0.0, 1.0)


def ramp(t: SquelchTables, g0: torch.Tensor, target: torch.Tensor, n: int
         ) -> torch.Tensor:
    """The gain over n audio samples [M, n], from g0 [M] toward target."""
    s = torch.arange(1, n + 1, dtype=torch.float64, device=g0.device)
    g0, target = g0[:, None], target[:, None]
    return torch.clamp(g0 + torch.sign(target - g0) * t.slope * s,
                       torch.minimum(g0, target), torch.maximum(g0, target))


def apply(t: SquelchTables, audio: torch.Tensor, rssi: torch.Tensor,
          leaves: dict, edge_rssi: torch.Tensor | None = None,
          margin: float = 0.0) -> tuple[torch.Tensor, dict, Decisions]:
    """audio [M, nc·n] float64, nc chunks of n samples; rssi [M, nc] dB,
    a column a chunk; `edge_rssi` [M, nc], the system's RSSI for the same
    chunks, decides where `rssi` lies within `margin` dB of a threshold.
    Returns (gated audio, the squelch leaves after the block, what the
    gate decided)."""
    M, nc = rssi.shape
    n = audio.shape[1] // nc
    open_, gain = leaves["squelch.open_"], leaves["squelch.gain"]
    dist = torch.minimum((rssi - t.thresh_db).abs(),
                         (rssi - t.close_db).abs())
    edge = torch.zeros_like(dist, dtype=torch.bool)
    if edge_rssi is not None:
        edge = dist <= margin
        rssi = torch.where(edge, edge_rssi.to(rssi), rssi)
    clear = dist[~edge]
    opened = shut = 0
    out = torch.empty_like(audio)
    for j in range(nc):
        target = decide(t, open_, rssi[:, j])
        opened += int((target > open_).sum())
        shut += int((target < open_).sum())
        g = ramp(t, gain, target, n)
        out[:, j * n:(j + 1) * n] = audio[:, j * n:(j + 1) * n] * g
        open_, gain = target, g[:, -1].clone()
    made = Decisions(int(edge.sum()), float(clear.min()) if clear.numel()
                     else math.inf, opened, shut)
    return out, {"squelch.open_": open_, "squelch.gain": gain}, made
