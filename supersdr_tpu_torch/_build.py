"""Build and load the hand-written CUDA kernels.

`nvcc` compiles every `csrc/*.cu` to an object, one process a source, all
started together, and links them into one shared library with a plain C
interface, which `ctypes` loads. The library lands in `build/` inside the
package (git-ignored), named by a hash of the sources and the flags, so an
edited source rebuilds at first use and an unchanged one loads at once.
Nothing here runs at import: `load()` builds on its first call, from the
wrapper that launches a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
GENCODE = "arch=compute_90a,code=sm_90a"
FLAGS = ["-gencode", GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_long

# C entry points and their argument types (every pointer and the stream as
# c_void_p, every stride as c_long, so none is cut to 32 bits); each returns
# a cudaError_t or a plain int.
SIGNATURES = {
    "channelize_fused_tile": [_I, _I, _I, _I],
    "channelize_fused_launch": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _P],
    "channelize_fused_raw3": [_P, _P, _I, _F, _P, _P, _P, _P, _P, _P, _P,
                              _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _P],
    "chain_tail_channels_per_block": [],
    "chain_tail_fir": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                       _I, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P],
    "chain_tail_am": [_P, _P, _L, _L, _I, _I, _P, _I, _I, _P, _I, _I, _I,
                      _I, _P, _P, _P, _L, _L, _P],
    "chain_tail_am_c": [_P, _L, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _P,
                        _P, _P, _L, _P],
    "chain_tail_launch": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    "pfb_fold_max_taps": [],
    "pfb_fold": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "halo_max_shards": [],
    "halo_empty_launch": [_P],
    "halo_push": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L,
                  _L, _L, _F, _F, _P],
    "peer_alloc": [_I, _L, _P],
    "peer_free": [_I, _P],
    "peer_handle_bytes": [],
    "peer_ipc_handle": [_I, _P, _P],
    "peer_ipc_open": [_I, _P, _P],
    "peer_ipc_close": [_I, _P],
    "squelch_gate": [_P, _I, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libsupersdr_kernels_{source_hash()}.so"


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def compile_command(src: Path, obj: Path) -> list[str]:
    return [nvcc(), *FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs: list[Path], out: Path) -> list[str]:
    return [nvcc(), "-gencode", GENCODE, "-shared", *map(str, objs), "-o",
            str(out)]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise if any fails. Returns their
    output, each followed by a line `nvcc <last argument>: <seconds> s`."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        logs = [open(os.path.join(tmp, f"{i}.log"), "w+")
                for i in range(len(cmds))]
        try:
            procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT,
                                      text=True)
                     for c, f in zip(cmds, logs)]
            took = [0.0] * len(procs)
            left = set(range(len(procs)))
            while left:
                for i in sorted(left):
                    if procs[i].poll() is not None:
                        took[i] = time.perf_counter() - t0
                        left.discard(i)
                time.sleep(0.05)
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
        finally:
            for f in logs:
                f.close()
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{o}")
    return "".join(f"{o}nvcc {os.path.basename(c[-1])}: {t:.1f} s\n"
                   for c, o, t in zip(cmds, outs, took))


def build() -> tuple[Path, str]:
    """Compile the sources unless the hashed library exists. Returns the
    library path and the compiler's output (ptxas register and shared
    memory report; empty when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{source_hash()}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources()]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        log = _run_all([compile_command(s, o)
                        for s, o in zip(sources(), objs)])
        log += _run_all([link_command(objs, tmp)])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return out, log


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry's argument types."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
