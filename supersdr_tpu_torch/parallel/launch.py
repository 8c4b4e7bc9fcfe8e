"""Run a function in several processes joined by a gloo group.

`spawn(fn, world, init_file, *args)` starts `world` fresh Python processes
(`torch.multiprocessing`, the spawn method, so a parent that has touched a
card may start them), joins them in one `torch.distributed` gloo group
over a file store (`init_file`, a path no other group uses: no TCP port to
pick) and calls `fn(rank, world, *args)` in each; the meshes they make then
split their time shards over the processes (`parallel/collectives.py`). It
returns the results in rank order, and raises if a process raised (with
its traceback) or did not finish within `timeout` seconds (the processes
are then killed). The results travel pickled: return plain values or numpy
arrays, not tensors. Before it leaves, every process waits for its card
and meets the others once more, so no process frees a buffer that a peer
may still write.

On one card every process uses that card; gloo carries only the handshakes
there (`ops/cuda/peer.py`), never NCCL, which refuses two ranks on one
device.
"""

from __future__ import annotations

import os
import queue
import time
import traceback
from datetime import timedelta


def _child(fn, rank: int, world: int, init_file: str, timeout: float,
           results, args) -> None:
    import torch
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout))
        out = fn(rank, world, *args)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dist.barrier()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, init_file: str, *args, timeout: float = 60.0
          ) -> list:
    """fn(rank, world, *args) in `world` processes; their results in rank
    order (see the module's docstring). `fn` must be importable by name
    (a module-level function)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world, init_file, timeout, results,
                               args)) for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(got)} of {world} processes"
                                   f" did not finish within {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                if dead and all(p.exitcode for r, p in enumerate(procs)
                                if r in dead):
                    raise RuntimeError(f"processes {dead} exited without a "
                                       f"result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
