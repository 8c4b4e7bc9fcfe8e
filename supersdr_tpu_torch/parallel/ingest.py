"""Ingest for a sharded capture: which time range a process owns, and
the capture placed on the mesh with its shard axis.

Counterpart of `supersdr_tpu/parallel/ingest.py`. In the reference every
host reads the time range its devices own and `make_global_iq` assembles
the per-process blocks into one sharded array, so no host holds the whole
capture. The port's mesh lives on one device (`parallel/mesh.py`), so in
one process the capture is that process's block, laid out `[*batch, D,
n_local]` on `mesh.device`. Several processes need the transport across
cards (ROADMAP queue 1 #10c), which does not exist yet: `make_global_iq`
raises there.
"""

from __future__ import annotations

import numpy as np
import torch

from supersdr_tpu_torch.parallel.mesh import TIME_AXIS, Mesh


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """`torch.distributed.init_process_group` when a coordinator address
    is given ("host:port" or a URL such as "tcp://localhost:29500"), with
    NCCL where there is a card and gloo elsewhere; a no-op otherwise."""
    if coordinator is None:
        return
    import torch.distributed as dist
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=url, world_size=num_processes, rank=process_id)


def _process_grid() -> tuple[int, int]:
    """(this process's rank, the number of processes)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_time_range(total_samples: int, mesh: Mesh,
                     time_axis: str = TIME_AXIS) -> tuple[int, int]:
    """[start, end) of the capture's time axis this process owns: its
    equal share of the mesh's time shards (all of them in one process)."""
    n_time = mesh.shape[time_axis]
    rank, world = _process_grid()
    if n_time % world:
        raise ValueError(f"{n_time} time shards do not split over {world} "
                         f"processes")
    shard = total_samples // n_time
    per = n_time // world
    return rank * per * shard, (rank + 1) * per * shard


def make_global_iq(local_block, global_shape: tuple[int, ...], mesh: Mesh,
                   time_axis: str = TIME_AXIS) -> torch.Tensor:
    """The capture on `mesh.device` with its time shard axis: a block
    [*batch, n] (this process's range, `local_time_range`; in one process
    the whole capture, of `global_shape`) → [*batch, D, n/D], D the
    mesh's time shards. `.flatten(-2)` gives the sharded chain's input."""
    _, world = _process_grid()
    if world > 1:
        raise NotImplementedError(
            "a capture across processes needs the transport across cards "
            "(ROADMAP queue 1 #10c)")
    block = torch.as_tensor(np.asarray(local_block)) \
        if not isinstance(local_block, torch.Tensor) else local_block
    if tuple(block.shape) != tuple(global_shape):
        raise ValueError(f"block {tuple(block.shape)} is not the global "
                         f"shape {tuple(global_shape)} in one process")
    D = mesh.shape[time_axis]
    if block.shape[-1] % D:
        raise ValueError(f"{block.shape[-1]} samples do not split over {D} "
                         f"time shards")
    return block.to(mesh.device).reshape(*block.shape[:-1], D, -1)
