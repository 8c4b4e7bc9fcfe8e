"""DSP ops on torch tensors: host-side plans and tables (numpy, float64
design → float32 tensors) and, under `ops/cuda/`, the hand-written
kernels with their plain PyTorch versions."""
