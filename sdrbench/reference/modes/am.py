"""AM: the envelope of the filtered channel, its one-pole DC blocker, then
the AGC."""

from __future__ import annotations

import torch

from sdrbench.reference import agc
from sdrbench.reference.scans import linear_scan

PASSBAND = (-6000.0, 6000.0)
LEAVES = ("demod.dc_x", "demod.dc_y", "agc.peak_db", "agc.gain_db")


def tables(dep: dict, iq_rate: int) -> dict:
    return {"dc_pole": dep["dc_pole"], "agc": agc.tables(dep["agc"], iq_rate)}


def zero(M: int, device) -> dict:
    f = dict(dtype=torch.float64, device=device)
    return {"demod.dc_x": torch.zeros(M, **f),
            "demod.dc_y": torch.zeros(M, **f),
            "agc.peak_db": torch.full((M,), -120.0, **f),
            "agc.gain_db": torch.zeros(M, **f)}


def demod(t: dict, y: torch.Tensor, st: dict
          ) -> tuple[torch.Tensor, dict]:
    env = y.abs()
    diff = env - torch.cat([st["demod.dc_x"][:, None], env[:, :-1]], dim=1)
    dc = linear_scan(t["dc_pole"], diff, st["demod.dc_y"])
    del diff
    out, peak, gain = agc.apply(t["agc"], dc, st["agc.peak_db"],
                                st["agc.gain_db"])
    return out, {"demod.dc_x": env[:, -1].clone(),
                 "demod.dc_y": dc[:, -1].clone(),
                 "agc.peak_db": peak[:, -1].clone(),
                 "agc.gain_db": gain[:, -1].clone()}
