"""Copies of the tree with a phase of the time-major tails compiled out or
changed, to time beside the tree with `kernel_ab.py`.

    python3 supersdr_tpu_torch/tools/tail_phases.py DEST [NAME ...]

writes DEST/<NAME>/ (`supersdr_tpu_torch/` without its build outputs, and
`chip_smoke.py`) for each NAME (default: all), with `csrc/chain_tail.cu`
edited in both time-major entries (`chain_tail_fir`, `chain_tail_am`:
`no_resampler`, `no_stores`), in the FIR entry only (`no_fir`,
`no_scans`, `no_window`, `no_loads`, `stagger`) or in the 8-channel
non-FIR entry only (`exchange*`):

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
  exchange            the audio as whole 128-byte lines through the 4-block
                      cluster (`tail_exchange.patch`): a warp a channel in
                      the resampler, 4 input samples a lane; each block
                      stages its rows in shared memory and, after a cluster
                      barrier, stores a quarter of the rows for all 32
                      channels, loading 16 bytes at a time from the four
                      blocks over distributed shared memory (first measured
                      on both time-major entries; its FIR-entry part went
                      with the FIR kernel it edited);
  exchange_no_stores  exchange without the global stores;
  exchange_local      exchange's resampler and staging, but each block
                      stores its own 8 channels' 32-byte row pieces, with
                      block barriers in place of the cluster barriers and
                      no distributed shared memory.

DEST should be a directory that .gitignore lists (`.scratch/`). The
phase copies' audio disagrees with the plain versions by design; the
exchange copies' audio is the tree's. Then

    python3 supersdr_tpu_torch/tools/kernel_ab.py \\
        --what tail_fast,tail_quality,am_time . DEST/exchange ...

times them against the tree in turns (A B B A).
"""

from __future__ import annotations

import argparse
import re
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SOURCE = Path("supersdr_tpu_torch") / "csrc" / "chain_tail.cu"
PATCH = Path(__file__).resolve().parent / "tail_exchange.patch"

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
_X_STORE = "        if (n < tlen && ch < a.C)\n          __stcs("
_X_ROUND = "    for (int r0 = 0; r0 < kRS; r0 += nr) {\n"
_X_ROUND_END = ("      cluster_arrive();  // this staging area is free again\n"
                "    }\n")
_X_LOCAL_ROUND = """    for (int r0 = 0; r0 < kRS; r0 += nr) {
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRS; ++r)
        if (r >= r0 && r < r0 + nr)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            my[8 * (((lane << sh) + 4 * (r - r0) + q) ^ (lane & 3))] =
                acc[r][q];
      __syncthreads();
      for (int ci = tid; ci < 256 * nr; ci += kThreads) {
        const int rho = ci >> 1, l = rho >> sh, sw = l >> 2;
        float4 u = reinterpret_cast<const float4*>(
            sm.stg)[2 * (rho ^ (l & 3)) + ((ci & 1) ^ (sw >> 2))];
        if (sw & 1) u = make_float4(u.y, u.x, u.w, u.z);
        if (sw & 2) u = make_float4(u.z, u.w, u.x, u.y);
        const int n = h + kRS * l + r0 + ((rho & ((1 << sh) - 1)) >> 2);
        const int ch = cl0 + (int)rank * kCB + 4 * (ci & 1);
        if (n < tlen && ch < a.C)
          __stcs(reinterpret_cast<float4*>(
                     a.audio + (((long)t0 + n) * 4 + (rho & 3)) * a.a_st +
                     ch),
                 u);
      }
    }
"""


def _replace(src: str, old: str, new: str, count: int) -> str:
    if src.count(old) != count:
        raise SystemExit(f"tail_phases: expected {count} of {old!r} in "
                         f"{SOURCE}, found {src.count(old)}")
    return src.replace(old, new)


def apply_patch(src: str, patch: str) -> str:
    """src with the hunks of a one-file unified diff applied in order, each
    found by its exact old lines."""
    lines = src.splitlines(keepends=True)
    out: list = []
    pos = 0
    for hunk in re.split(r"^@@ [^\n]* @@[^\n]*\n", patch, flags=re.M)[1:]:
        old = [ln[1:] for ln in hunk.splitlines(keepends=True)
               if ln[:1] in (" ", "-")]
        new = [ln[1:] for ln in hunk.splitlines(keepends=True)
               if ln[:1] in (" ", "+")]
        at = next((i for i in range(pos, len(lines) - len(old) + 1)
                   if lines[i:i + len(old)] == old), None)
        if at is None:
            raise SystemExit(f"a hunk of the patch does not apply (after "
                             f"line {pos + 1} of the source)")
        out += lines[pos:at] + new
        pos = at + len(old)
    return "".join(out + lines[pos:])


def _exchange(src: str) -> str:
    return apply_patch(src, PATCH.read_text())


def _exchange_local(src: str) -> str:
    src = _exchange(src)
    start = src.index(_X_ROUND)
    end = src.index(_X_ROUND_END, start) + len(_X_ROUND_END)
    if src.count(_X_ROUND) != 1 or src.count(_X_ROUND_END) != 1:
        raise SystemExit("tail_phases: the exchange's round is not unique")
    return src[:start] + _X_LOCAL_ROUND + src[end:]


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
    "exchange": _exchange,
    "exchange_no_stores": lambda s: _replace(
        _exchange(s), _X_STORE, _X_STORE.replace("a.C)", "a.C && t0 < 0)"),
        1),
    "exchange_local": _exchange_local,
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
