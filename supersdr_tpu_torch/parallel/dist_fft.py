"""Distributed four-step FFT: the tensor-parallel (TP) axis.

Counterpart of `supersdr_tpu/parallel/dist_fft.py`: an N = N1·N2
Cooley-Tukey FFT whose N1 rows are sharded over a mesh axis,

  1. each shard FFTs its local rows over N2        (no communication)
  2. twiddle multiply W_N^{n1·k2}                   (elementwise, local)
  3. transpose N1 ↔ N2 through ONE `all_to_all`     (the only collective)
  4. each shard FFTs its local rows over N1        (no communication)

The shards are a leading tensor axis on one device (as every mesh of the
port's); the transpose goes through `collectives.all_to_all`. The local
FFTs are `torch.fft` (the reference left them to XLA; no hand kernel).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from supersdr_tpu_torch.ops import cx
from supersdr_tpu_torch.parallel import collectives
from supersdr_tpu_torch.parallel.sharded_wideband import Mesh, make_mesh

__all__ = ["Mesh", "build_fft", "fft_sharded", "make_mesh",
           "shuffle_index", "unshuffle_index"]


@lru_cache(maxsize=16)
def _twiddle(n1: int, n2: int, d: int, sign: int, device: torch.device
             ) -> torch.Tensor:
    """W^{j1·k2} for the global row j1 of each shard's rows, [d, n1/d, n2]
    complex64 (angles in float64)."""
    j1 = torch.arange(n1, dtype=torch.float64, device=device)
    k2 = torch.arange(n2, dtype=torch.float64, device=device)
    ang = sign * 2.0 * np.pi * torch.remainder(
        j1[:, None] * k2[None, :], n1 * n2) / (n1 * n2)
    return torch.polar(torch.ones_like(ang), ang).to(
        torch.complex64).reshape(d, n1 // d, n2)


def fft_sharded(x: torch.Tensor, n1: int, n2: int, sign: int = -1
                ) -> torch.Tensor:
    """Distributed FFT of x viewed as [n1, n2] row-major (x[j] =
    x_flat[j1·n2 + j2]), rows j1 sharded: x [d, n1/d, n2] complex64, shard
    s holding rows s·n1/d …. Returns each shard's part of the output viewed
    as [n2, n1] (X[k] = X_flat[k2·n1 + k1], k2 sharded): [d, n2/d, n1].
    `unshuffle_index` maps it back to natural frequency order."""
    d = x.shape[0]
    # step 1: local FFTs along n2
    y = torch.fft.fft(x, dim=-1) if sign < 0 else \
        torch.fft.ifft(x, dim=-1) * n2
    # step 2: twiddle W^{j1·k2} for the global row j1
    y = y * _twiddle(n1, n2, d, sign, x.device)
    # step 3: global transpose — every shard sends column block q of its
    # rows to shard q, which stacks the blocks in row order: [d, n1, n2/d]
    y = collectives.all_to_all(y, 1, 0).transpose(-1, -2)
    # step 4: local FFTs along n1
    y = torch.fft.fft(y, dim=-1) if sign < 0 else \
        torch.fft.ifft(y, dim=-1) * n1
    if sign > 0:
        y = y / (n1 * n2)
    return y


def shuffle_index(n1: int, n2: int) -> np.ndarray:
    """Input load (Bailey column-major): matrix row j1 holds x[j1 + n1·j2],
    so flat position p = j1·n2 + j2 reads sample (p // n2) + n1·(p % n2)."""
    p = np.arange(n1 * n2)
    return (p // n2) + n1 * (p % n2)


def unshuffle_index(n1: int, n2: int) -> np.ndarray:
    """Output store: X_natural[k] = out_flat[(k % n2)·n1 + k // n2]."""
    k = np.arange(n1 * n2)
    return (k % n2) * n1 + k // n2


def build_fft(n: int, mesh: Mesh, sign: int = -1):
    """A distributed FFT of length n over `mesh`, natural-order output
    (the final unshuffle included). Returns f(x: CX [n]) -> CX [n] on
    `mesh.device`; x may also be complex numpy."""
    d = mesh.n_shards
    if n % (d * d):
        raise ValueError("n must be divisible by d^2 for the row/column "
                         "block exchange")
    n1 = d * max(1, int(np.sqrt(n // d)) // d * d)
    while n % n1 or (n // n1) % d:
        n1 += d
    n2 = n // n1
    pre = torch.as_tensor(shuffle_index(n1, n2), device=mesh.device)
    post = torch.as_tensor(unshuffle_index(n1, n2), device=mesh.device)

    def f(x) -> cx.CX:
        x = cx.as_cx(x, device=mesh.device)
        xs = torch.complex(x.re[pre], x.im[pre]).reshape(d, n1 // d, n2)
        y = fft_sharded(xs, n1, n2, sign).reshape(-1)[post]
        return cx.CX(y.real.contiguous(), y.imag.contiguous())

    return f
