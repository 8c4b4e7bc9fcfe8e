"""The squelch gate's device time a chunk, ms: over the traced slice, the
device operations the program launched inside its `chain.tail.squelch`
spans (paired in the stream's order by the span's marker kernels,
`sdrbench/gate.py`), summed, over the gates."""

from sdrbench import gate


def read(ctx):
    if ctx["trace"] is None:
        return None
    return gate.device_ms(ctx)
