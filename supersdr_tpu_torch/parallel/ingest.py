"""Ingest for a sharded capture: which time range a process owns, and
the capture placed on the mesh with its shard axis.

Counterpart of `supersdr_tpu/parallel/ingest.py`. In the reference every
host reads the time range its devices own and `make_global_iq` assembles
the per-process blocks into one sharded array, so no host holds the whole
capture. Here a process's block stays that process's: laid out `[*batch,
d_local, n_local]` on `mesh.device`, its time shards on the tensor axis,
the mesh's transport (`parallel/collectives.py`) reaching the other
processes' shards (gloo on the CPU; CUDA IPC between processes on one
card; across cards not built). In one process the block is the whole
capture.
"""

from __future__ import annotations

import numpy as np
import torch

from supersdr_tpu_torch.parallel.mesh import TIME_AXIS, Mesh


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str = "gloo") -> None:
    """`torch.distributed.init_process_group` when a coordinator address
    is given ("host:port" or a URL such as "tcp://localhost:29500" or
    "file:///path"); a no-op otherwise. The backend is gloo unless the
    caller asks for another: the mesh's transport moves its data itself
    (`parallel/collectives.py`) over a gloo group and refuses any other
    (an NCCL group puts each process on a card of its own, and across
    cards is not built); NCCL also refuses two ranks on one card."""
    if coordinator is None:
        return
    import torch.distributed as dist
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend=backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def local_time_range(total_samples: int, mesh: Mesh,
                     time_axis: str = TIME_AXIS) -> tuple[int, int]:
    """[start, end) of the capture's time axis this process owns: its
    equal share of the mesh's time shards (all of them in one process)."""
    n_time = mesh.shape[time_axis]
    rank, world = mesh.rank, mesh.world
    if n_time % world:
        raise ValueError(f"{n_time} time shards do not split over {world} "
                         f"processes")
    shard = total_samples // n_time
    per = n_time // world
    return rank * per * shard, (rank + 1) * per * shard


def make_global_iq(local_block, global_shape: tuple[int, ...], mesh: Mesh,
                   time_axis: str = TIME_AXIS) -> torch.Tensor:
    """This process's part of the capture on `mesh.device` with its time
    shard axis: a block [*batch, n / world] (this process's range,
    `local_time_range`, of a capture of `global_shape`; in one process the
    whole capture) → [*batch, d_local, n/D], D the mesh's time shards.
    `.flatten(-2)` gives the sharded chain's input."""
    block = torch.as_tensor(np.asarray(local_block)) \
        if not isinstance(local_block, torch.Tensor) else local_block
    D, world = mesh.shape[time_axis], mesh.world
    want = (*global_shape[:-1], global_shape[-1] // world)
    if tuple(block.shape) != want or global_shape[-1] % world:
        raise ValueError(f"block {tuple(block.shape)} is not this "
                         f"process's {want} of {tuple(global_shape)}")
    if global_shape[-1] % D:
        raise ValueError(f"{global_shape[-1]} samples do not split over {D} "
                         f"time shards")
    return block.to(mesh.device).reshape(*block.shape[:-1], D // world, -1)
