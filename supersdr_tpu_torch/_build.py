"""Build and load the hand-written CUDA kernels.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
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
from functools import lru_cache
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
GENCODE = "arch=compute_90a,code=sm_90a"
FLAGS = ["-gencode", GENCODE, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types (every pointer and the stream as
# c_void_p, so none is cut to 32 bits); each returns a cudaError_t.
SIGNATURES = {
    "channelize_fused_tile": [_I, _I],
    "channelize_fused_raw3": [_P, _P, _I, _F, _P, _P, _P, _P, _P, _P, _P,
                              _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "chain_tail_channels_per_block": [],
    "chain_tail_fir": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                       _P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P],
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


def nvcc_command(out: Path) -> list[str]:
    return [nvcc(), *FLAGS, "-o", str(out), *map(str, sources())]


def build() -> tuple[Path, str]:
    """Compile the sources unless the hashed library exists. Returns the
    library path and the compiler's output (ptxas register and shared
    memory report; empty when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    return out, proc.stdout + proc.stderr


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
