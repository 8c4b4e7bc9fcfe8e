"""The share of a replay's traced chunks that found their plan held, %:
the program's plan counter (`supersdr_tpu_torch.utils.profiling.
count_plan`), read by `sdrbench/plan_hits.py`. The plan is built in the
warm-up, so every traced chunk of a replay should find it held: 100."""

from sdrbench import plan_hits


def read(ctx):
    return plan_hits.hit_pct(ctx)
