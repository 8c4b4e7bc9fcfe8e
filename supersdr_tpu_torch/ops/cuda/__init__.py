"""Hand-written Hopper kernels (sources in `supersdr_tpu_torch/csrc/`),
the counterparts of `supersdr_tpu/ops/pallas/`.

Each module holds the kernel's wrapper and its plain PyTorch version.
The wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises) — it never falls back. Each wrapper
counts its launches in a `launches` attribute."""

import torch


def check_fp32_matmul(t: torch.Tensor) -> None:
    """The plain versions are the float32 references on the card too: with
    TF32 matmuls (about three decimal digits) they would be the less exact
    side of a kernel comparison, so they refuse to run under it."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("plain versions need "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
