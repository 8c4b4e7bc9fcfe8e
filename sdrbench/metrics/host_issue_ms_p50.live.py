"""The host's own work a live chunk, ms: the median over the traced
chunks of the time inside the monitor's `monitor.push` and
`monitor.selected_audio` spans less the time inside the spans in which
the host waits for a copy (`spans.CROSSINGS`: the input's copy to the
device, the RSSI means' and the listened row's fetches): Python, the
launches and the glue the host issues."""

import statistics

from sdrbench import spans

ROOTS = ("monitor.push", "monitor.selected_audio")


def read(ctx):
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    sp = rec[0]
    total = spans.ms_by_chunk(sp, ROOTS)
    wait = spans.ms_by_chunk(sp, spans.CROSSINGS)
    if not any(total.values()):
        return None
    return statistics.median(total[c] - wait[c] for c in total)
