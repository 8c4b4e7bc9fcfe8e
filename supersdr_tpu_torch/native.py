"""ctypes bindings to the native sdrkit library (native/sdrkit.cpp).

Compiled on demand with g++ into the port's git-ignored build/ directory
(under a temporary name, then renamed, so concurrent processes never load
a half-written library; the reference's build next to the source is left
alone); every caller falls back to the pure-python/numpy path when the
toolchain or library is unavailable, so the framework never hard-depends
on the extension.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "sdrkit.cpp"
_SO = Path(__file__).resolve().parent / "build" / "libsdrkit.so"

_lib = None
_tried = False


class AdpcmStateC(ctypes.Structure):
    _fields_ = [("index", ctypes.c_int32), ("prev", ctypes.c_int32)]


def _build() -> bool:
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    try:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def load():
    """The loaded library or None. Builds once if needed."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        if not _SRC.exists() or not _build():
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i16 = ctypes.POINTER(ctypes.c_int16)
    f32 = ctypes.POINTER(ctypes.c_float)
    st = ctypes.POINTER(AdpcmStateC)
    lib.adpcm_decode.argtypes = [u8, ctypes.c_int64, i16, st]
    lib.adpcm_encode.argtypes = [i16, ctypes.c_int64, u8, st]
    lib.be16_to_f32.argtypes = [u8, ctypes.c_int64, f32]
    lib.be16_iq_to_c64.argtypes = [u8, ctypes.c_int64, ctypes.c_float, f32]
    lib.be16_iq_split_i16.argtypes = [u8, ctypes.c_int64, i16, i16]
    lib.xor_mask.argtypes = [u8, ctypes.c_int64, u8]
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_int64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_size.argtypes = [ctypes.c_void_p]
    lib.rb_size.restype = ctypes.c_int64
    lib.rb_write.argtypes = [ctypes.c_void_p, f32, ctypes.c_int64]
    lib.rb_write.restype = ctypes.c_int64
    lib.rb_read.argtypes = [ctypes.c_void_p, f32, ctypes.c_int64]
    lib.rb_read.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def adpcm_decode(data: bytes | np.ndarray, state) -> np.ndarray | None:
    """state: ops.adpcm.AdpcmState (updated in place). None → no library."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(data), np.uint8)
    out = np.empty(2 * len(buf), np.int16)
    cst = AdpcmStateC(index=state.index, prev=state.prev)
    lib.adpcm_decode(_u8ptr(buf), len(buf),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                     ctypes.byref(cst))
    state.index, state.prev = cst.index, cst.prev
    return out


def adpcm_encode(samples: np.ndarray, state) -> bytes | None:
    lib = load()
    if lib is None:
        return None
    s = np.ascontiguousarray(samples, np.int16)
    if len(s) % 2:
        s = np.append(s, s[-1])
    out = np.empty(len(s) // 2, np.uint8)
    cst = AdpcmStateC(index=state.index, prev=state.prev)
    lib.adpcm_encode(s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                     len(s), _u8ptr(out), ctypes.byref(cst))
    state.index, state.prev = cst.index, cst.prev
    return out.tobytes()


def be16_to_f32(payload: bytes) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(payload, np.uint8)
    out = np.empty(len(buf) // 2, np.float32)
    lib.be16_to_f32(_u8ptr(buf), len(out),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def be16_iq_to_c64(payload: bytes, scale: float = 1.0) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(payload, np.uint8)
    n_pairs = len(buf) // 4
    out = np.empty(2 * n_pairs, np.float32)
    lib.be16_iq_to_c64(_u8ptr(buf), n_pairs, scale,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out.view(np.complex64)


def be16_iq_split_i16(payload: bytes
                      ) -> tuple[np.ndarray, np.ndarray] | None:
    """Interleaved big-endian IQ int16 wire payload → split (re, im)
    int16 planes — the wideband `process_i16` ingest format. None when
    the native library is unavailable (callers fall back to numpy)."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(payload, np.uint8)
    n_pairs = len(buf) // 4
    re = np.empty(n_pairs, np.int16)
    im = np.empty(n_pairs, np.int16)
    lib.be16_iq_split_i16(_u8ptr(buf), n_pairs,
                          re.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                          im.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return re, im


def xor_mask(data: bytearray | np.ndarray, mask: bytes) -> None:
    """In-place RFC6455 unmask/mask. Caller must pass a writable buffer."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    arr = np.frombuffer(data, np.uint8)
    m = np.frombuffer(mask, np.uint8)
    lib.xor_mask(_u8ptr(arr), len(arr), _u8ptr(m))


class RingBuffer:
    """Native SPSC float ring buffer (audio callback ↔ compute thread)."""

    def __init__(self, capacity: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.rb_create(capacity)
        self.capacity = capacity

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None

    def write(self, data: np.ndarray) -> int:
        d = np.ascontiguousarray(data, np.float32)
        return self._lib.rb_write(
            self._h, d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(d))

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = self._lib.rb_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        return out[:got]

    def __len__(self) -> int:
        return self._lib.rb_size(self._h)
