"""supersdr_tpu_torch — the PyTorch + CUDA port of supersdr_tpu.

The JAX package `supersdr_tpu` stays the reference; this package mirrors
its layout (`ops/`, `ops/cuda/` for the hand-written Hopper kernels that
replace `ops/pallas/`, `runtime/`, `parallel/`) and its public names, so
each module's counterpart is easy to find. It imports `torch` and never
`jax`.

It runs the receiver chain (`runtime.chain.process` / `run_offline`, every
mode, passband, resampler and control), the wideband pipeline's planar,
time-major, chan-major and fallback tiers (`runtime.wideband.process` /
`process_n` / `process_many` / `process_i16`) and the receiver chain
sharded over a ('chan', 'time') mesh held on one device
(`parallel.sharded_chain.build`, with the mesh forms of the scans, the
demodulators and the AGC) on five hand-written kernels; and the user's
entry points on them: the CLI (`python -m supersdr_tpu_torch.cli demod |
waterfall | wideband | kiwi`), the live KiwiSDR session, the receiver
controller, dual RX, the spectrum/waterfall ops and the ADPCM codec. What
it does not run yet raises `NotImplementedError` naming the ROADMAP item
that will bring it. It imports nothing of the JAX package: the
framework-free modules it shares with it (`ops/firdesign`, `ops/passband`,
`io/`, `display/`, parts of `control/` and `runtime/`, `native`) are
carried over as copies.
"""

__all__: list[str] = []
