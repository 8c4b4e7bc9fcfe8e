"""A cell of the benchmark cut to a size the CPU runs in seconds: 512
channels of 12 kHz (a 6.144 MHz capture, the planar tier's smallest
factoring) and 512-frame chunks, the configuration and traffic otherwise
as their files state, the cell's own limits."""

from __future__ import annotations

import copy

import torch

from sdrbench import check
from sdrbench import run as R

N_CHAN = 512
SEED = 2 ** 31 + 11


def cell(name: str, seed: int = SEED, seconds: float = 0.6,
         conf_update: dict | None = None) -> R.Cell:
    """The cell at the small size; `conf_update` changes its configuration
    further (a `deployment` in it updates the deployment's keys)."""
    spec = R.load_spec()
    wl, conf, traffic = R.find_cell(spec, name)
    conf, traffic = copy.deepcopy(conf), copy.deepcopy(traffic)
    conf["deployment"].update(n_chan=N_CHAN, fs_in=N_CHAN * 12000)
    update = copy.deepcopy(conf_update or {})
    conf["deployment"].update(update.pop("deployment", {}))
    conf.update(update)
    traffic.update(frames=512, warmup_chunks=2)
    if traffic["driver"] == "replay":
        traffic.update(ring_chunks=4, check=dict(
            first_chunks=3, late_chunks=2, rows=32))
    else:
        traffic.update(ring_chunks=8, check=dict(ref_block_chunks=4))
    return R.Cell(wl["name"], conf, traffic, seed, seconds, False,
                  torch.device("cpu"), check.load_limits(wl["name"]))


def execute(c: R.Cell, make_system) -> tuple[dict, list[str]]:
    torch.set_num_threads(4)
    return R.execute(c, make_system, R.load_spec())
