"""Time the channelizer and tail kernels of several copies of the tree on
one card, in turns, to compare versions inside one run.

    python3 supersdr_tpu_torch/tools/kernel_ab.py [--what NAMES] TREE ...

Each TREE is a directory that holds `supersdr_tpu_torch/` and
`chip_smoke.py` (the repository root itself, or a copy of both made under a
git-ignored directory and edited there: an earlier version, or one with a
phase of a kernel compiled out to see what the phase costs). All trees
build first, in parallel, each into its own `supersdr_tpu_torch/build/`;
then each tree's kernels are timed in its own process, first in the order
given and then in reverse (A B B A), so a drift of the card shows. Shapes,
inputs and the plain versions are `chip_smoke.py`'s at HEADLINE (2560
channels × 16128 frames; the time store at 16200). NAMES, comma
separated: chan_fast, chan_quality (float32 and int16 raw planes and the
time store), tail_fast, tail_quality (the FIR tail on the channelizer's
planes), am (the non-FIR tail). In the first turn every kernel is also held
against its plain version and the SNR printed (nothing is asserted: a copy
with a phase compiled out disagrees by design). Each process prints one
line `RESULT <tree> {name: [ms, ms], ...}`: two CUDA-event means of 10
launches each.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ALL = ("chan_fast", "chan_quality", "tail_fast", "tail_quality", "am")


def time_tree(what: tuple, check: bool) -> None:
    """Time the kernels of the tree in the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from supersdr_tpu_torch import _build
    from supersdr_tpu_torch.runtime import wideband as wb
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    _build.load()
    gen = torch.Generator(device=dev).manual_seed(3)
    res = {}

    def run(name, kernel, plain):
        if check:
            try:
                cs._compare(name, "", kernel, plain, -float("inf"), dev, {})
            except AssertionError as e:     # not a number
                print(f"  {e}", flush=True)
        res[name] = [round(cs.cuda_ms(kernel, 10), 4) for _ in range(2)]

    for prof in ("fast", "quality"):
        if f"chan_{prof}" not in what and f"tail_{prof}" not in what:
            continue
        cfg = wb.WidebandConfig(**cs.HEADLINE, **wb.PROFILES[prof])
        params = wb.make_params(cfg, device=dev)
        kernel, plain = cs._chan_case(cfg, params, gen, i16=False, device=dev)
        raw = kernel()
        if f"chan_{prof}" in what:
            run(f"chan_{prof}_f32", kernel, plain)
            run(f"chan_{prof}_i16", *cs._chan_case(cfg, params, gen, i16=True,
                                                   device=dev))
            tcfg = wb.WidebandConfig(**cs.TMAJOR, **wb.PROFILES[prof])
            run(f"chan_{prof}_time", *cs._chan_case(
                tcfg, params, gen, i16=False, device=dev, layout="time"))
        if f"tail_{prof}" in what:
            run(f"tail_{prof}", *cs._tail_case(cfg, params, gen, device=dev,
                                               raw=raw))
        del raw, kernel, plain
    if "am" in what:
        y = torch.randn(2560, 16128, generator=gen, device=dev,
                        dtype=torch.complex64) * 0.05
        run("am", *cs._am_case(2560, 16128, gen, device=dev, y=y))
    print("RESULT", os.path.basename(os.getcwd()), json.dumps(res),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--what", default=",".join(ALL))
    ap.add_argument("--one", action="store_true",
                    help="time the tree in the current directory")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    what = tuple(args.what.split(","))
    if set(what) - set(ALL):
        ap.error(f"--what takes {', '.join(ALL)}")
    if args.one:
        time_tree(what, args.check)
        return 0
    if not args.trees:
        ap.error("name at least one tree")
    me = os.path.abspath(__file__)
    build = ("import os, sys; sys.path.insert(0, os.getcwd()); "
             "from supersdr_tpu_torch import _build; _build.build()")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=t)
             for t in args.trees]
    if any(p.wait() for p in procs):
        print("kernel_ab: a tree failed to build", file=sys.stderr)
        return 1
    turns = [(t, True) for t in args.trees] + \
        [(t, False) for t in reversed(args.trees)]
    rc = 0
    for tree, check in turns:
        cmd = [sys.executable, me, "--one", "--what", args.what]
        rc |= subprocess.run(cmd + ["--check"] * check, cwd=tree).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
