"""How often a traced chunk found the program's fixed plan held.

`supersdr_tpu_torch.utils.profiling.count_plan` records, by chunk, whether
the chunk found its plan held or built some of it (the tier, the row
orders, tiles, tap tables and parameter vectors the program holds across
chunks), only while a `torch.profiler` runs; `profiling.plans()` reads
them. A version of the program that records no plans (no `plans`) gives
None, and so does a traced run in which no chunk recorded one.
"""

from __future__ import annotations

from sdrbench import spans


def recorded(ctx: dict):
    """(spans, {chunk: built}) of a traced run, or None."""
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    from supersdr_tpu_torch.utils import profiling
    read = getattr(profiling, "plans", None)
    if read is None:
        return None
    return rec[0], read()


def hit_pct(ctx: dict) -> float | None:
    """The share of the traced chunks (those of a root span) that found
    their plan held, %; None where no chunk recorded a plan."""
    rec = recorded(ctx)
    if rec is None:
        return None
    sp, plans = rec
    ids = spans.chunks(sp)
    if not ids or not any(c in plans for c in ids):
        return None
    return 100.0 * sum(plans.get(c) is False for c in ids) / len(ids)
