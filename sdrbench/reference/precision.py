"""Rounding to a precision below the one a configuration states: the
control that each cell's limits must reject.

Each rounder maps a float64 tensor to float64 values representable in the
lower format (round to nearest). `fp8_e4m3` scales the tensor by its
largest magnitude first, as a real fp8 path would (unscaled, these
signals would fall below fp8's normal range); `tf32` keeps float32's
exponent and 10 bits of mantissa.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.to(torch.float32).view(torch.int32)
    # round to nearest on the 13 dropped mantissa bits, ties away
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(torch.float64)


def _fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = float(x.abs().max()) / FP8_MAX
    if scale == 0.0:
        return x
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float64) * scale


ROUNDERS = {"tf32": _tf32, "fp8_e4m3": _fp8_e4m3}


def rounder(name: str):
    try:
        return ROUNDERS[name]
    except KeyError:
        raise ValueError(f"unknown precision {name!r}; "
                         f"one of {sorted(ROUNDERS)}") from None
