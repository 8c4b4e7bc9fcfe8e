"""The host's waits a live chunk, ms: the median over the traced chunks
of the time inside the spans in which the host waits for a copy
(`spans.CROSSINGS`: `wideband.ingest`, the input's two planes to the
device; `monitor.rssi_fetch`, which also waits out the chunk's device
work; `monitor.audio_fetch`, the listened row)."""

from sdrbench import spans


def read(ctx):
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    sp = rec[0]
    if not any(s.name == "monitor.push" for s in sp):
        return None
    return spans.median_by_chunk(sp, spans.CROSSINGS)
