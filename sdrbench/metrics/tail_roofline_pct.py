"""The FIR chain tail kernel's share of its roofline, %: the least time of
one launch at the algorithm's boundary (`roofline/chain_tail_fir.py`)
over its mean device time a launch in the traced slice."""

from sdrbench import roofline


def read(ctx):
    if ctx["trace"] is None:
        return None
    return roofline.share_pct(ctx["trace"], "chain_tail_fir", ctx["conf"],
                              ctx["frames"])
