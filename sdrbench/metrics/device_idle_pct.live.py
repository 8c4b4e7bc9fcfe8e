"""The device's idle share inside the monitor's pushes, %: over the traced
chunks, the host's time from each push to the return of the listened
channel's fetch, against the device's busy time in the traced window (a
chunk's device work lies inside its push: the fetch waits for it, and the
next chunk is due tens of ms later)."""

from sdrbench import trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device or not tr.span_s:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / sum(tr.span_s))
