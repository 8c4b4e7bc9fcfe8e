"""supersdr_tpu_torch — the PyTorch + CUDA port of supersdr_tpu.

The JAX package `supersdr_tpu` stays the reference; this package mirrors
its layout (`ops/`, `ops/cuda/` for the hand-written Hopper kernels that
replace `ops/pallas/`, `runtime/`) and its public names, so each module's
counterpart is easy to find. It imports `torch` and never `jax`.

Slice 1 holds the wideband main path: `runtime.wideband.process_n` on the
planar tier (fused channelizer → FIR-fused chain tail). Everything else
raises `NotImplementedError` naming the ROADMAP item that will bring it.

The two framework-free numpy modules of the reference that the slice
needs (`supersdr_tpu.ops.firdesign` and `supersdr_tpu.ops.passband`) are
imported as they are; neither `supersdr_tpu/__init__.py` nor
`supersdr_tpu/ops/__init__.py` imports JAX.
"""

__all__: list[str] = []
