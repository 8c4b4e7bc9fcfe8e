"""The host's time inside the receiver's process call (the wideband
receiver's `process_i16`, through the monitor's process function), ms a
chunk, the median over the window's chunks (traced with CUDA activity
alone, which adds a little to each launch)."""

import statistics


def read(ctx):
    d = ctx.get("dispatch_ms")
    if not d:
        return None
    return statistics.median(d)
