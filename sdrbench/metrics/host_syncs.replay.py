"""Blocking host↔device crossings a replay chunk, a count: what the
program's counter (`supersdr_tpu_torch.utils.profiling.count_sync`) holds
for each traced chunk, where every chunk holds the same. The replay's
chunks are on the device already: 0."""

from sdrbench import spans


def read(ctx):
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    return spans.syncs_per_chunk(*rec)
