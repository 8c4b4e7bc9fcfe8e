"""The FIR chain tail (`csrc/chain_tail.cu`, `chain_tail_fir_kernel`): the
passband FIR, AM demodulation, DC block, AGC, ×L interpolation and RSSI of
every channel of one chunk.

Bytes: the channel planes in the configuration's plane precision, read
once; the passband history (complex float32, n_taps − 1 a channel) and
the tail state (DC blocker, AGC, interpolator history: 4 + per − 1
float32 a channel) read once and written once; the float32 audio and the
RSSI written once. Operations: 4·n_taps a sample for the FIR (real taps on
complex samples; the AM passband is real), 2·per·L a sample for the
interpolator.
"""

from __future__ import annotations

from sdrbench.reference import design
from sdrbench.roofline import BYTES

KERNEL = "chain_tail_fir_kernel"


def counts(conf: dict, frames: int) -> tuple[float, float]:
    dep = conf["deployment"]
    M, n_taps = dep["n_chan"], dep["n_taps"]
    iq_rate = dep["fs_in"] // M
    per, L = design.interp_matrix(iq_rate, dep["audio_rate"]).shape
    n = M * frames
    plane = BYTES[conf["precision"]["planes"]]
    state = M * ((n_taps - 1) * 2 * 4 + (4 + per - 1) * 4)
    n_bytes = n * 2 * plane + 2 * state + n * L * 4 + M * 4
    flops = (4 * n_taps + 2 * per * L) * n
    return float(n_bytes), float(flops)
