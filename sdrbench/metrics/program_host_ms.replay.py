"""The host's time inside the wideband receiver's `process` a chunk, ms:
the median over the traced slice's chunks of the program's own
`wideband.process` span (`supersdr_tpu_torch.utils.profiling`), its
dispatch of the chunk whole: ingest, plan, the channelizer's and the
tail's calls and the glue between them. Read on the host-bound fast
replay only: on a device-bound cell the span times the launch queue's
back-pressure, not the host's work."""

from sdrbench import spans


def read(ctx):
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    return spans.median_by_chunk(rec[0], ("wideband.process",))
