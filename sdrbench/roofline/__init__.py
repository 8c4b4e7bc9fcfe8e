"""Kernel rooflines: the table of peaks and a kernel's share of its least
time.

Each kernel has a file of its own here, `<kernel>.py`, with `KERNEL`, the
name its device events carry, and `counts(conf, frames)`, the bytes and
operations of one launch counted at the algorithm's boundary: every input
read once and every output written once in the precision the
configuration states, and the operations the algorithm needs, whatever
the implementation reads again or computes twice. So any implementation
of the same work reads the same count, and none can read above 100 %.
"""

from __future__ import annotations

import importlib

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAKS = {"hbm_bytes_s": 3.35e12, "tensor_flops": 989e12}
BYTES = {"bf16": 2, "f32": 4, "sc16": 2}


def kernel(name: str):
    """The module of a kernel's counts, found by its file name."""
    return importlib.import_module(f"sdrbench.roofline.{name}")


def least_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: bytes over the memory rate
    against operations over the tensor cores' rate."""
    return max(n_bytes / PEAKS["hbm_bytes_s"], flops / PEAKS["tensor_flops"])


def share_pct(trace, name: str, conf: dict, frames: int) -> float | None:
    """The kernel's least time over its mean device time a launch, in %;
    None where the trace holds none of its launches."""
    mod = kernel(name)
    ev = [e for e in trace.device if mod.KERNEL in e.name]
    if not ev:
        return None
    per_launch_s = sum(e.end - e.start for e in ev) * 1e-6 / len(ev)
    return 100.0 * least_s(*mod.counts(conf, frames)) / per_launch_s
