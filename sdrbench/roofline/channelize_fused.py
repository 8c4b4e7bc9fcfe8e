"""The channelizer (`csrc/channelize_fused.cu`, `channelize_mma_kernel`):
the polyphase fold and the M-point DFT of one chunk.

Bytes: the chunk's IQ in its wire format (sc16), the PFB history (complex
float32) and the prototype taps (float32), read once; the channel planes
written once in the configuration's plane precision. Operations: 4·K a
sample for the fold (a real tap on a complex sample), 5·M·log2(M) a frame
for the DFT.
"""

from __future__ import annotations

import math

from sdrbench.roofline import BYTES

KERNEL = "channelize_mma_kernel"


def counts(conf: dict, frames: int) -> tuple[float, float]:
    dep = conf["deployment"]
    M, K = dep["n_chan"], dep["taps_per"]
    n = M * frames
    plane = BYTES[conf["precision"]["planes"]]
    n_bytes = (n * 2 * BYTES["sc16"] + (K - 1) * M * 2 * 4 + K * M * 4
               + n * 2 * plane)
    flops = 4 * K * n + 5 * M * math.log2(M) * frames
    return float(n_bytes), float(flops)
