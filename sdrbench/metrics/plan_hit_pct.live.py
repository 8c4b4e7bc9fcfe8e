"""The share of the live window's chunks that found their plan held, %:
the program's plan counter (`supersdr_tpu_torch.utils.profiling.
count_plan`) by chunk of the monitor's push, read by
`sdrbench/plan_hits.py`. The warm-up builds the plan: 100 where every
chunk of the window holds it."""

from sdrbench import plan_hits


def read(ctx):
    return plan_hits.hit_pct(ctx)
