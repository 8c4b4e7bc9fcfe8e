"""Mesh description for SDR workloads.

Counterpart of `supersdr_tpu/parallel/mesh.py`. The parallel axes of a
software-radio pipeline:

  chan  virtual receivers (embarrassingly parallel)
  time  contiguous blocks of one stream, coupled by halo exchanges of
        filter history and by two-level scans

A port `Mesh` is a pair of shard counts, one `torch.device` and the
transport that moves data between its shards (`comm`,
`parallel/collectives.py`). In one process the shards are slices of tensor
axes on that device. With a `torch.distributed` group of `world` processes
each process holds `d_local = n_time / world` consecutive time shards,
rank r the global shards r·d_local …; the 'chan' axis stays whole in every
process (it is a batch axis and moves nothing).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from supersdr_tpu_torch.device import default_device  # noqa: F401 (alias)
from supersdr_tpu_torch.parallel import collectives

CHAN_AXIS = "chan"
TIME_AXIS = "time"


@dataclass(frozen=True)
class Mesh:
    n_chan: int
    n_time: int
    device: torch.device
    comm: collectives.Transport = field(
        default_factory=collectives.Transport, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {CHAN_AXIS: self.n_chan, TIME_AXIS: self.n_time}

    @property
    def rank(self) -> int:
        return self.comm.rank

    @property
    def world(self) -> int:
        return self.comm.world

    @property
    def d_local(self) -> int:
        """Time shards in this process."""
        return self.n_time // self.comm.world


def make_mesh(n_chan: int | None = None, n_time: int | None = None,
              device=None, n_shards: int | None = None, *,
              world: int | None = None) -> Mesh:
    """A ('chan', 'time') mesh of n_chan × n_time shards on `device` (the
    current CUDA device unless one is given; without a card, pass
    device="cpu"). With `n_shards` (the reference's device count) a
    missing axis is filled in from it — neither given: all shards on the
    channel axis — and the product must equal it; without it a missing
    axis is 1. The time shards split over the processes of an initialised
    `torch.distributed` group (`collectives.for_processes`; `world=1`: all
    in this process)."""
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
    device = default_device(device)
    return Mesh(int(n_chan), int(n_time), device,
                collectives.for_processes(int(n_time), device, world))


def time_mesh(n_time: int, device=None, *, world: int | None = None
              ) -> Mesh:
    """All shards on the time axis (pure sequence-parallel)."""
    return make_mesh(1, n_time, device=device, world=world)
