"""The squelch gate's share of its roofline, %: the least time of the
traced slice's gates at their boundary (`roofline/squelch.py`, bytes from
the channels each gate met, by the program's gate counter) over their
device time (`sdrbench/gate.py`)."""

from sdrbench import gate, roofline
from sdrbench.roofline import squelch


def read(ctx):
    if ctx["trace"] is None:
        return None
    ms, met = gate.device_ms(ctx), gate.met(ctx)
    if ms is None or met is None or ms <= 0:
        return None
    gates = len(gate.gate_spans(ctx))
    n_bytes, flops = squelch.counts(ctx["conf"], ctx["frames"], *met)
    return 100.0 * roofline.least_s(n_bytes, flops) / (ms * 1e-3 * gates)
