"""NCO phase state. The wideband channelizer's outputs are already
channel-centred, so the slice never mixes; the phase (a fraction of a
cycle in [0, 1)) travels through `ChainState` unchanged."""

from __future__ import annotations

import torch


def init_phase(batch_shape: tuple[int, ...] = (),
               device=None) -> torch.Tensor:
    return torch.zeros(batch_shape, dtype=torch.float32, device=device)
