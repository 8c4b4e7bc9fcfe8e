"""The device's idle share of the traced slice, %: the part of the slice
(a synchronise on each side, its length on the host's clock) in which no
kernel, copy or set runs, from the union of the device's intervals."""

from sdrbench import trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / tr.window_s)
