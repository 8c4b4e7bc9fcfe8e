"""Copies of the tree with one phase of the channelizer kernel compiled
out, to time beside the tree with `kernel_ab.py`.

    python3 supersdr_tpu_torch/tools/chan_phases.py DEST [NAME ...]

writes DEST/<NAME>/ (`supersdr_tpu_torch/` without its build outputs, and
`chip_smoke.py`) for each NAME (default: all), with
`csrc/channelize_fused.cu` edited:

  no_stageb  phase 1 (the fold and stage A) only: stage B does not run, Y
             is not read and no raw plane or time store is written;
  no_phase1  Y is zeroed once and phase 1 does not run: stage B and the
             stores as they are, on zeros;
  no_tables  phase 1 with its table loads (the fold taps, the stage-A
             factors) replaced by constants (in the earlier design one
             constant for every output, which let the compiler share stage A's
             arithmetic between outputs; here one for each);
  one_shard  the shard offsets as constants 0 (right for one shard only,
             as `kernel_ab.py`'s chan_* cases are, the mesh form aside):
             what the run-time offsets of the mesh form cost the plain form.

Each phase is compiled out behind a run-time condition that never holds
(`nf < 0`), so the compiler keeps what the other phases do. The edits find
their lines in both designs of the kernel (stage A factored, and the
earlier one with the folded stage-A table); a source that holds neither
stops the tool. The tool copies the tree it sits in: to split an older
tree's kernel, put this file in that tree's `supersdr_tpu_torch/tools/`
and run it there. DEST should be a directory that .gitignore lists
(`.scratch/`). The copies' outputs disagree with the plain version by
design. Then

    python3 supersdr_tpu_torch/tools/kernel_ab.py \\
        --what chan_fast,chan_quality . DEST/no_stageb DEST/no_phase1 \\
        DEST/no_tables

times them against the tree in turns (A B B A).
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SOURCE = Path("supersdr_tpu_torch") / "csrc" / "channelize_fused.cu"

_STAGEB = "  for (int nb = warp * kWN; nb < n2; nb += kWarps * kWN) {\n"
_STAGES = "  for (int s = 0; s < n_stages; ++s) {\n"
_PASSES = "    while (s < n_stages) {\n"
_PHASE1 = "  // ---- phase 1: fold + stage A"
_ZERO_Y = ("  for (int i = tid; i < NP * (int)ylo; i += kThreads)\n"
           "    ys[i] = __float2bfloat16_rn(0.f);\n"
           "  __syncthreads();\n")
_TAPS = ("      g[k] = __ldg(g2 + (long)min(k, K - 1) * M + st.j1 * n2 + "
         "j2);\n")
_CONST_TAPS = "      g[k] = 0.125f;\n"

# Each phase: alternatives, one for each design of the kernel (the factored
# stage A first, then the earlier folded one); an alternative is a list of
# (old, new, count) edits that must all apply.
PHASES = {
    "no_stageb": [[(_STAGEB, _STAGEB.replace("nb < n2;", "nf < 0 && nb < n2;"),
                    1)]],
    "no_phase1": [[(_PASSES, _PASSES.replace("s < n_stages",
                                             "nf < 0 && s < n_stages"), 1),
                   (_PHASE1, _ZERO_Y + _PHASE1, 1)],
                  [(_STAGES, _STAGES.replace("s < n_stages",
                                             "nf < 0 && s < n_stages"), 1),
                   (_PHASE1, _ZERO_Y + _PHASE1, 1)]],
    "no_tables": [
        # taps a stage ahead, the n1-point DFT, the twiddle row (a constant
        # for each output, so no arithmetic is shared between outputs)
        [("      const float4 v = __ldg(gp + q);\n",
          "      const float4 v = make_float4(0.125f + q, 0.25f + q, "
          "0.375f + q, 0.5f + q);\n", 1),
         ("            const float2 w = wp[k1];\n",
          "            const float2 w = make_float2(0.5f + k1, 0.25f);\n", 1),
         ("            twk[k1] = __ldg(tw + (long)min(kg + k1, n1 - 1) * "
          "n2 +\n                            min(j2, n2 - 1));\n",
          "            twk[k1] = make_float2(0.5f + k1, 0.25f);\n", 1)],
        # taps and the folded stage-A factors, a stage ahead
        [(_TAPS, _CONST_TAPS, 1),
         ("      ar[k1] = __ldg(at_r + a);\n      ai[k1] = __ldg(at_i + a);\n",
          "      ar[k1] = 0.5f;\n      ai[k1] = 0.25f;\n", 1)]],
    # the shard offsets as constants 0: right for one shard only (the
    # kernel_ab.py chan_* cases but the mesh form), to see what the
    # run-time offsets cost the plain form
    "one_shard": [[("(long)blockIdx.y *", "0L *", 3)]],
}


def apply_phase(src: str, name: str) -> str:
    """src with PHASES[name] applied: the first alternative whose edits
    all find their lines, each the stated number of times."""
    for alt in PHASES[name]:
        if all(src.count(old) == n for old, _, n in alt):
            for old, new, _ in alt:
                src = src.replace(old, new)
            return src
    raise SystemExit(f"chan_phases: {name}: no design of the kernel in "
                     f"{SOURCE} matches the tool's lines")


def make_copy(dest: Path, name: str) -> Path:
    """DEST/name: the tree with PHASES[name] applied to the channelizer."""
    out = dest / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(REPO / "supersdr_tpu_torch", out / "supersdr_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy2(REPO / "chip_smoke.py", out / "chip_smoke.py")
    path = out / SOURCE
    path.write_text(apply_phase(path.read_text(), name))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dest", type=Path)
    ap.add_argument("names", nargs="*", default=list(PHASES))
    args = ap.parse_args()
    if set(args.names) - set(PHASES):
        ap.error(f"names: {', '.join(PHASES)}")
    for name in args.names:
        print(make_copy(args.dest, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
