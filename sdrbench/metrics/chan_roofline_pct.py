"""The channelizer kernel's share of its roofline, %: the least time of
one launch at the algorithm's boundary (`roofline/channelize_fused.py`)
over its mean device time a launch in the traced slice."""

from sdrbench import roofline


def read(ctx):
    if ctx["trace"] is None:
        return None
    return roofline.share_pct(ctx["trace"], "channelize_fused", ctx["conf"],
                              ctx["frames"])
