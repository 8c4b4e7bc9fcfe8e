"""The device's idle share of the traced slice spent while the host was
inside the program, %: of the slice (`Trace.window_s`), the time in which
no device operation runs and the host is inside a `wideband.process` span,
the spans moved onto the trace's clock by `spans.base_ns`. A part of
`device_idle_pct.replay`; the rest is idle time outside the program (the
driver's loop, the slice's ends)."""

from sdrbench import spans


def read(ctx):
    tr, rec = ctx["trace"], spans.recorded(ctx)
    if tr is None or rec is None or not tr.device or tr.window_s <= 0:
        return None
    base = spans.base_ns(rec[0], tr.device)
    if base is None:
        return None
    chunks = [s for s in rec[0] if s.name == "wideband.process"]
    return 100.0 * spans.idle_in_s(chunks, base, tr.device) / tr.window_s
