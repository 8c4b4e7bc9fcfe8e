"""The glue around the two kernels, device ms a chunk: every device
operation of the traced slice (copies, sets, PyTorch's kernels: the
per-chunk argsort, gathers, the RSSI's dB) other than the channelizer's
and the FIR tail's launches, summed, over the chunks the slice ran."""

from sdrbench import roofline


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.chunks or not tr.device:
        return None
    kernels = [roofline.kernel(k).KERNEL
               for k in ("channelize_fused", "chain_tail_fir")]
    glue = sum(e.end - e.start for e in tr.device
               if not any(k in e.name for k in kernels))
    return glue * 1e-3 / tr.chunks
