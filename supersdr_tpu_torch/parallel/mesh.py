"""Mesh description for SDR workloads.

Counterpart of `supersdr_tpu/parallel/mesh.py`. The parallel axes of a
software-radio pipeline:

  chan  virtual receivers (embarrassingly parallel)
  time  contiguous blocks of one stream, coupled by halo exchanges of
        filter history and by two-level scans

A port `Mesh` is a pair of shard counts and one `torch.device`: the shards
are slices of tensor axes on that device, there is no device list.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from supersdr_tpu_torch.device import default_device  # noqa: F401 (alias)

CHAN_AXIS = "chan"
TIME_AXIS = "time"


@dataclass(frozen=True)
class Mesh:
    n_chan: int
    n_time: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {CHAN_AXIS: self.n_chan, TIME_AXIS: self.n_time}


def make_mesh(n_chan: int | None = None, n_time: int | None = None,
              device=None, n_shards: int | None = None) -> Mesh:
    """A ('chan', 'time') mesh of n_chan × n_time shards on `device` (the
    current CUDA device unless one is given; without a card, pass
    device="cpu"). With `n_shards` (the reference's device count) a
    missing axis is filled in from it — neither given: all shards on the
    channel axis — and the product must equal it; without it a missing
    axis is 1."""
    if n_shards is not None:
        if n_chan is None and n_time is None:
            n_chan, n_time = n_shards, 1
        elif n_chan is None:
            n_chan = n_shards // n_time
        elif n_time is None:
            n_time = n_shards // n_chan
        if n_chan * n_time != n_shards:
            raise ValueError(f"{n_chan}x{n_time} != {n_shards} shards")
    n_chan = 1 if n_chan is None else n_chan
    n_time = 1 if n_time is None else n_time
    if n_chan < 1 or n_time < 1:
        raise ValueError(f"shard counts must be positive, got "
                         f"{n_chan}x{n_time}")
    return Mesh(int(n_chan), int(n_time), default_device(device))


def time_mesh(n_time: int, device=None) -> Mesh:
    """All shards on the time axis (pure sequence-parallel)."""
    return make_mesh(1, n_time, device=device)
