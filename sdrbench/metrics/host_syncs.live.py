"""Blocking host↔device crossings a live chunk, a count: what the
program's counter (`supersdr_tpu_torch.utils.profiling.count_sync`) holds
for each traced chunk, where every chunk holds the same: the input's two
planes to the device, the RSSI means and the listened row to the host."""

from sdrbench import spans


def read(ctx):
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    return spans.syncs_per_chunk(*rec)
