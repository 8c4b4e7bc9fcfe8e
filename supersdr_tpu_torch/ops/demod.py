"""Demodulator state (AM / SSB / CW / NBFM).

Counterpart of `supersdr_tpu/ops/demod.py`'s state type; the demodulators
themselves run inside the chain-tail kernel, `ops/cuda/chain_tail.py`:

  USB/LSB/CW  audio = Re{y} (the one-sided passband makes y analytic)
  AM          envelope |y|, then a one-pole DC blocker
  NBFM        angle(y[n]·conj(y[n−1]))·fs/(2π·max_dev), muted where
              |Re|+|Im| of the product is at most NBFM_MUTE_FLOOR
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from supersdr_tpu_torch.ops import cx

# below this |Re p|+|Im p| of p = y[n]·conj(y[n−1]) the angle is
# numerical noise, so the discriminator outputs 0 (as the reference)
NBFM_MUTE_FLOOR = 1e-12


class DemodState(NamedTuple):
    """last_sample: previous complex input (NBFM); dc_x, dc_y: DC-blocker
    state (AM). Fields a mode does not use stay as they are."""
    last_sample: cx.CX
    dc_x: torch.Tensor
    dc_y: torch.Tensor


def init_state(batch_shape: tuple[int, ...] = (), device=None) -> DemodState:
    f = torch.zeros(batch_shape, dtype=torch.float32, device=device)
    return DemodState(last_sample=cx.zeros(batch_shape, device=device),
                      dc_x=f, dc_y=f.clone())
