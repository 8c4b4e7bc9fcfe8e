"""The two recursions of the receiver's channel chain as scans over a
block, on explicit state (float64 PyTorch)."""

from __future__ import annotations

import torch


def linear_scan(a: float, b: torch.Tensor, y0: torch.Tensor,
                block: int = 128) -> torch.Tensor:
    """y[n] = a·y[n−1] + b[n] along the last axis, y[−1] = y0: inside a
    block the product with the Toeplitz matrix of a's powers, then the
    blocks in order."""
    C, n = b.shape
    nb = -(-n // block)
    bb = torch.nn.functional.pad(b, (0, nb * block - n)).reshape(C, nb,
                                                                  block)
    i = torch.arange(block, device=b.device)
    e = (i[:, None] - i[None, :]).to(b.dtype)
    T = torch.where(e >= 0, a ** e.clamp_min(0), torch.zeros_like(e))
    w = bb @ T.T
    pw = a ** (i + 1).to(b.dtype)
    y = y0
    for k in range(nb):
        w[:, k] += pw * y[:, None]
        y = w[:, k, -1]
    return w.reshape(C, nb * block)[:, :n]


def maxplus_scan(d: float, b: torch.Tensor, y0: torch.Tensor
                 ) -> torch.Tensor:
    """y[n] = max(y[n−1] − d, b[n]), y[−1] = y0: y[n] = max over j ≤ n of
    b[j] − (n − j)·d, and y0 − (n + 1)·d."""
    j = torch.arange(b.shape[-1], dtype=b.dtype, device=b.device)
    cm = torch.cummax(b + j * d, dim=-1).values
    return torch.maximum(cm, y0[:, None] - d) - j * d
