"""The share of the live window's chunks that replayed a CUDA graph held
for the stream, %: the program's graph counter (`supersdr_tpu_torch.
utils.profiling.count_graph`) by chunk of the monitor's push. A chunk
that ran eagerly, or recorded its graph first, did not replay a held one.
None on a version of the program without the counter (no `graphs`), and
where no traced chunk recorded one (an eager process function, such as
the control's)."""

from sdrbench import spans


def read(ctx):
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    from supersdr_tpu_torch.utils import profiling
    graphs = getattr(profiling, "graphs", None)
    if graphs is None:
        return None
    graphs = graphs()
    ids = spans.chunks(rec[0])
    if not ids or not any(c in graphs for c in ids):
        return None
    return 100.0 * sum(graphs.get(c) is True for c in ids) / len(ids)
