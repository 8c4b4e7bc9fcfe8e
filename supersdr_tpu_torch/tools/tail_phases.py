"""Copies of the tree with a phase of the time-major tails compiled out or
changed, to time beside the tree with `kernel_ab.py`.

    python3 supersdr_tpu_torch/tools/tail_phases.py DEST [NAME ...]

writes DEST/<NAME>/ (`supersdr_tpu_torch/` without its build outputs, and
`chip_smoke.py`) for each NAME (default: all), with `csrc/chain_tail.cu`
edited in both time-major entries (`chain_tail_fir`, `chain_tail_am`:
`no_resampler`, `no_stores`), in the FIR entry only (`no_fir`,
`no_scans`, `no_window`, `no_loads`, `stagger`):

  no_resampler        no resampler and no audio out;
  no_stores           the resampler as it is, no global store;
  no_fir              no tensor-core FIR: y = the window's newest column
                      (its bf16 high piece);
  no_scans            no demod, DC block or AGC: the gained audio = y.re
                      (the state rows keep their input values);
  no_window           the window fed once, at the first tile: the input
                      rows are still copied into the ring after it, but
                      float32 rows are not split into bf16 pieces (the
                      bf16 rows of the fast tier need no pass: there the
                      copy is the tree);
  no_loads            no input rows copied after the first tile's: the
                      ring keeps tile 0 and its history;
  stagger             warps 0-3 run their share of the next tile's FIR
                      before their channel's scans, warps 4-7 after them,
                      so that the tensor cores and the CUDA cores would
                      work at once (measured and not kept: slower on both
                      tiers);

DEST should be a directory that .gitignore lists (`.scratch/`). The
phase copies' audio disagrees with the plain versions by design. Then

    python3 supersdr_tpu_torch/tools/kernel_ab.py \\
        --what tail_fast,tail_quality,am_time . DEST/no_fir ...

times them against the tree in turns (A B B A).
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SOURCE = Path("supersdr_tpu_torch") / "csrc" / "chain_tail.cu"

_CALL = "\n    tail_resample_any(a, "
_FIR = ("  constexpr int tiles = kTile / 16 / kCB;  // row tiles a warp: a "
        "pair\n")
_NO_FIR = """  if (kTile > 0) {  // no FIR: y = the window's newest column
    for (int t = w * (kTile / kCB) + lane; t < (w + 1) * (kTile / kCB);
         t += 32) {
      const int slot = (tau0 + fl.OVP + t) & Rm;
      for (int pl = 0; pl < 2; ++pl) {
        const uint4 u = ring[(size_t)pl * fl.R + slot];
        const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&u);
        for (int c = 0; c < kCB; ++c)
          (pl ? yim + c * fl.Sim : yre + c * fl.Sre)[skew(t)] =
              __bfloat162float(v[c]);
      }
    }
    return;
  }
"""
_SCAN = "      tail_scan<kDemod>(a, pows, rw, cr, t0, tlen, 1);\n"
_LAND = "    if (xb && fl.np == 1) return;\n"
_FIR_CALL = ("    if (more) {\n      float* yn = ybase + (b ^ 1) * "
             "fl.ybuf();\n")
_FIR_ARGS = ("      fir_tile<kCplx, !kFirBf16>(G, ring, fl, yn + skew(fl.H),\n"
             "                                 yn + kCB * fl.Sre, t0 + T - "
             "fl.OVP);\n")
_TILE_END = ("    __syncthreads();\n"
             "    if (t0 + 2 * T < nf) fetch(t0 + 2 * T);\n")
_FETCH = "  if (T < nf) fetch(T);\n"
_STORE = "          dst[(((long)t0 + n0 + r) * 4 + q) * a.a_st] = acc[r][q];\n"


def _replace(src: str, old: str, new: str, count: int) -> str:
    if src.count(old) != count:
        raise SystemExit(f"tail_phases: expected {count} of {old!r} in "
                         f"{SOURCE}, found {src.count(old)}")
    return src.replace(old, new)


EDITS = {
    "no_resampler": lambda s: _replace(s, _CALL, "\n    if (nf < 0) "
                                       + _CALL.lstrip("\n "), 2),
    "no_stores": lambda s: _replace(s, _STORE, "          if (t0 < 0) "
                                    + _STORE.lstrip(), 1),
    "no_fir": lambda s: _replace(s, _FIR, _FIR + _NO_FIR, 1),
    "no_scans": lambda s: _replace(s, _SCAN, "      if (nf < 0) "
                                   + _SCAN.lstrip(), 1),
    "no_window": lambda s: _replace(s, _LAND, _LAND.replace(
        "xb && fl.np == 1", "(xb && fl.np == 1) || t0 > 0"), 1),
    "no_loads": lambda s: _replace(
        _replace(s, _FETCH, _FETCH.replace("(T < nf)", "(nf < 0)"), 1),
        _TILE_END, _TILE_END.replace("(t0 + 2 * T < nf)", "(nf < 0)"), 1),
    "stagger": lambda s: _replace(
        _replace(s, _FIR_CALL, _FIR_CALL.replace("(more)", "(more && w < 4)"),
                 1), _TILE_END,
        "    if (more && w >= 4) {\n      float* yn = ybase + (b ^ 1) * "
        "fl.ybuf();\n" + _FIR_ARGS + "    }\n" + _TILE_END, 1),
}


def make_copy(dest: Path, name: str) -> Path:
    """DEST/name: the tree with EDITS[name] applied to the tail source."""
    out = dest / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(REPO / "supersdr_tpu_torch", out / "supersdr_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy2(REPO / "chip_smoke.py", out / "chip_smoke.py")
    path = out / SOURCE
    path.write_text(EDITS[name](path.read_text()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dest", type=Path)
    ap.add_argument("names", nargs="*", default=list(EDITS))
    args = ap.parse_args()
    if set(args.names) - set(EDITS):
        ap.error(f"names: {', '.join(EDITS)}")
    for name in args.names:
        print(make_copy(args.dest, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
