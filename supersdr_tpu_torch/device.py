"""The device the port's public constructors use when given none, and the
pinned staging of per-chunk host input onto it.

The port is written for a CUDA card, so `device=None` means the current
CUDA device; where there is none it raises instead of picking the CPU, so
a run on the CPU is always one the caller asked for (`device="cpu"`, as
the CPU tests do).
"""

from __future__ import annotations

import numpy as np
import torch

# pinned buffers a PinnedStager rings through: the chunks that may be in
# flight at once
STAGER_DEPTH = 2


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


class PinnedStager:
    """Per-chunk host input onto a device through a ring of pinned host
    buffers: a copy from pageable memory waits for the card, one from
    pinned memory is queued behind the work already there. A buffer is
    reused only once the copy that last read it has finished, so
    STAGER_DEPTH chunks may be in flight. On the CPU the array is taken as
    it is."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._key = None
        self._slots: list = []
        self._next = 0

    def put(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        if self.device.type != "cuda":
            return torch.from_numpy(arr)
        if self._key != (arr.shape, arr.dtype):
            self._key = (arr.shape, arr.dtype)
            self._slots = [[torch.from_numpy(np.empty_like(arr)).pin_memory(),
                            None] for _ in range(STAGER_DEPTH)]
            self._next = 0
        slot = self._slots[self._next]
        self._next = (self._next + 1) % STAGER_DEPTH
        if slot[1] is not None:
            slot[1].synchronize()
        slot[0].numpy()[...] = arr
        # the copy runs on the target device's current stream, which need
        # not be the current device's: the event is recorded there
        out = slot[0].to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(self.device))
        return out
