"""The squelch gate in a traced slice: the device operations the program
launched inside its gate spans, and the channels its gate met.

The program (`supersdr_tpu_torch.utils.profiling`) runs each chunk's gate
in a span `chain.tail.squelch` which, on a card, launches a marker kernel
(`profiling.MARKER_KERNEL`) on the stream as it opens and as it closes,
and counts the channels each chunk's gate met settled open, settled shut
and moving (`profiling.gates()`), only while a profiler runs. The device
trace that `sdrbench/trace.py` keeps holds the device's operations alone,
with no launch events and no correlation ids, so each gate span is paired
with its operations in the stream's order: those between its two
markers, which the one stream runs in the order they were launched. A
version of the program without the span, the markers or the counter, or
a trace whose markers do not pair with the spans, gives None.
"""

from __future__ import annotations

from sdrbench import spans

SPAN = "chain.tail.squelch"


def gate_spans(ctx: dict) -> list | None:
    """The traced slice's gate spans, or None where it recorded none."""
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    sp = [s for s in rec[0] if s.name == SPAN]
    return sp or None


def gate_ops(ctx: dict) -> list | None:
    """[[device operations]]: each gate span's, in the stream's order."""
    sp = gate_spans(ctx)
    if sp is None:
        return None
    from supersdr_tpu_torch.utils import profiling
    marker = getattr(profiling, "MARKER_KERNEL", None)
    if marker is None:
        return None
    dev = sorted(ctx["trace"].device, key=lambda e: e.start)
    at = [i for i, e in enumerate(dev) if marker in e.name]
    if len(at) != 2 * len(sp):
        return None
    return [dev[a + 1:b] for a, b in zip(at[::2], at[1::2])]


def device_ms(ctx: dict) -> float | None:
    """Device ms a gate (a chunk) of the operations inside gate spans."""
    ops = gate_ops(ctx)
    if ops is None:
        return None
    return sum(e.end - e.start for g in ops for e in g) * 1e-3 / len(ops)


def met(ctx: dict) -> tuple | None:
    """(settled open, settled shut, moving) channel-chunks summed over the
    chunks of the slice's gate spans; None where a chunk counted none."""
    sp = gate_spans(ctx)
    if sp is None:
        return None
    from supersdr_tpu_torch.utils import profiling
    read = getattr(profiling, "gates", None)
    if read is None:
        return None
    counts = read()
    ids = [s.chunk for s in sp]
    if any(c not in counts for c in ids):
        return None
    return tuple(sum(counts[c][i] for c in ids) for i in range(3))
