"""Minimal PNG encoder (stdlib zlib only) for headless waterfall renders."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """rgb: [H, W, 3] uint8."""
    rgb = np.asarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))
    Path(path).write_bytes(data)


def read_png_size(path: str | Path) -> tuple[int, int]:
    head = Path(path).read_bytes()[:33]
    w, h = struct.unpack(">II", head[16:24])
    return w, h
