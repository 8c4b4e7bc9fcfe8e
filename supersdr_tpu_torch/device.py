"""The device the port's public constructors use when given none.

The port is written for a CUDA card, so `device=None` means the current
CUDA device; where there is none it raises instead of picking the CPU, so
a run on the CPU is always one the caller asked for (`device="cpu"`, as
the CPU tests do).
"""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """`device` as a `torch.device` with a CUDA index made explicit.
    None: the current CUDA device; without one, RuntimeError."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
