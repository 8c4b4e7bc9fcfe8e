"""Split-complex pairs at the public boundary.

The reference carries complex values as two float planes (`cx.CX`)
because its TPU runtime could not move complex64 buffers. The port keeps
that layout at its public functions only, so its inputs, outputs and
state compare one to one with the reference's; inside, it uses whatever
layout suits the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CX(NamedTuple):
    """z = re + i·im as two same-shape float32 tensors."""
    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    @property
    def device(self) -> torch.device:
        return self.re.device

    def to(self, device) -> "CX":
        return CX(self.re.to(device), self.im.to(device))


def zeros(shape, device=None) -> CX:
    return CX(torch.zeros(shape, dtype=torch.float32, device=device),
              torch.zeros(shape, dtype=torch.float32, device=device))


def as_cx(x, device=None) -> CX:
    """Coerce to a float32 CX on `device` (None keeps the input's): CX,
    complex numpy arrays and complex tensors are split; real input gets
    a zero imaginary plane."""
    if isinstance(x, CX):
        re, im = x.re, x.im
        if not isinstance(re, torch.Tensor):
            re, im = torch.as_tensor(np.asarray(re)), \
                torch.as_tensor(np.asarray(im))
    elif isinstance(x, np.ndarray):
        re = torch.from_numpy(np.ascontiguousarray(x.real, np.float32))
        im = (torch.from_numpy(np.ascontiguousarray(x.imag, np.float32))
              if np.iscomplexobj(x) else torch.zeros_like(re))
    elif isinstance(x, torch.Tensor) and x.is_complex():
        re, im = x.real, x.imag
    else:
        re = torch.as_tensor(x)
        im = torch.zeros_like(re)
    if device is not None:
        re, im = re.to(device), im.to(device)
    return CX(re.to(torch.float32).contiguous(),
              im.to(torch.float32).contiguous())


def as_complex(x, device=None) -> torch.Tensor:
    """Coerce as `as_cx` does, to one complex64 tensor on `device`."""
    z = as_cx(x, device)
    return torch.complex(z.re, z.im)
