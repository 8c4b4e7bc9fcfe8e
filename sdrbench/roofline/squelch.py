"""The squelch gate of one chunk (`runtime/chain.py`'s `chain.tail.squelch`
span, PyTorch's elementwise passes today): the least bytes it has to move
at its boundary, which is the tail's float32 audio in memory.

The bytes depend on what the gate met, so they are counted from the
program's gate counter (`profiling.count_gate`) and not from the audio's
size: a channel that moves (its gain ramps, or stays strictly between 0
and 1) reads and writes its n = frames · L audio samples; a channel that
settles shut only writes zeros; a channel that settles open leaves its
audio as it is. Every channel besides reads its RSSI and reads and writes
the gate's two state leaves (open state and gain). So a gate that skips
settled channels reads the same count, and none can read above 100 %.
The gate does no work the tensor cores could take: no operations counted.
"""

from __future__ import annotations

from sdrbench.reference import design
from sdrbench.roofline import BYTES


def audio_samples(conf: dict, frames: int) -> int:
    """A channel's audio samples in a chunk of `frames` frames."""
    dep = conf["deployment"]
    _, L = design.interp_matrix(dep["fs_in"] // dep["n_chan"],
                                dep["audio_rate"]).shape
    return frames * L


def counts(conf: dict, frames: int, settled_open: int, settled_shut: int,
           moving: int) -> tuple[float, float]:
    """(bytes, operations) of the gate over `settled_open + settled_shut
    + moving` channel-chunks."""
    n = audio_samples(conf, frames)
    audio = BYTES[conf["precision"]["audio"]]
    state = BYTES[conf["precision"]["state"]]
    channels = settled_open + settled_shut + moving
    n_bytes = (moving * 2 * n * audio + settled_shut * n * audio
               + channels * (BYTES["f32"] + 2 * 2 * state))
    return float(n_bytes), 0.0
