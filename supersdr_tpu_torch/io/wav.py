"""KiwiSDR IQ WAV files (GNSS-timestamped) and plain audio WAV I/O.

The KiwiSDR records IQ as a RIFF/WAVE file whose `data` chunks are
interleaved with vendor `kiwi` chunks carrying GNSS timestamps
(`<BBII` = last_gps_solution, dummy, gpssec, gpsnsec). The true sample rate
is estimated from consecutive GNSS seconds with an EWMA and timestamps are
emitted only once the estimate has settled — the same observable behavior
as the reference reader (kiwi/wavreader.py:12-112): frames
0-2 seed the rate, later frames blend 0.9·old + 0.1·new, and per-sample
times start at frame 3.

Also provides the audio recorder sink (mono int16 WAV at the audio rate,
behavior of `audio_recording`, utils_supersdr.py:144-172)
and a KiwiSDR-format IQ WAV *writer* used by tests and by the capture tool.
"""

from __future__ import annotations

import struct
import wave
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


class KiwiIQWavError(Exception):
    pass


@dataclass
class IQFrame:
    gps_solution: int
    gpssec: float
    z: np.ndarray          # complex64 IQ samples
    t: np.ndarray | None   # per-sample times (None while rate is settling)
    samplerate: float


def _read_chunks(raw: bytes):
    """Iterate (fourcc, payload) over a RIFF body, honoring word alignment."""
    pos = 0
    n = len(raw)
    while pos + 8 <= n:
        cid = raw[pos:pos + 4]
        (size,) = struct.unpack("<I", raw[pos + 4:pos + 8])
        payload = raw[pos + 8:pos + 8 + size]
        yield cid, payload
        pos += 8 + size + (size & 1)


class KiwiIQWavReader:
    """Streaming reader over (kiwi, data) chunk pairs."""

    def __init__(self, filename: str | Path):
        raw = Path(filename).read_bytes()
        if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
            raise KiwiIQWavError("not a RIFF/WAVE file")
        self._chunks = _read_chunks(raw[12:])
        cid, payload = next(self._chunks)
        if cid != b"fmt ":
            raise KiwiIQWavError("fmt chunk is missing")
        fmt_tag, nch, self.samplerate, _, block_align = struct.unpack(
            "<HHLLH", payload[:14])
        if not (fmt_tag == 1 and nch == 2 and block_align == 4):
            raise KiwiIQWavError("this is not a KiwiSDR IQ wav file")
        self._frame_counter = 0
        self._last_gpssec = -1.0
        self._rate = float(self.samplerate)

    def __iter__(self):
        return self

    def __next__(self) -> IQFrame:
        try:
            cid, payload = next(self._chunks)
        except StopIteration:
            raise StopIteration from None
        if cid != b"kiwi":
            raise KiwiIQWavError("missing KiwiSDR GNSS time stamp")
        sol, _, gpssec, gpsnsec = struct.unpack("<BBII", payload[:10])
        gps = gpssec + 1e-9 * gpsnsec
        cid, payload = next(self._chunks)
        if cid != b"data":
            raise KiwiIQWavError("missing WAVE data chunk")
        z = (np.frombuffer(payload, dtype=np.int16).astype(np.float32)
             .view(np.complex64) / 65535.0)
        n = len(z)
        if self._last_gpssec >= 0:
            inst = n / (gps - self._last_gpssec)
            if self._frame_counter < 3:
                self._rate = inst
            else:
                self._rate = 0.9 * self._rate + 0.1 * inst
        t = None
        if self._frame_counter >= 2:
            t = gps + np.arange(n, dtype=np.float64) / self._rate
        self._last_gpssec = gps
        self._frame_counter += self._frame_counter < 3
        return IQFrame(gps_solution=sol, gpssec=gps, z=z, t=t,
                       samplerate=self._rate)


def read_kiwi_iq_wav(filename: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate all settled frames → (t, z); reference behavior
    (kiwi/wavreader.py:104-112 skips frames whose t is None)."""
    ts, zs = [], []
    for frame in KiwiIQWavReader(filename):
        if frame.t is None:
            continue
        ts.append(frame.t)
        zs.append(frame.z)
    if not ts:
        raise KiwiIQWavError("no settled GNSS-timestamped frames found")
    return np.concatenate(ts), np.concatenate(zs)


def write_kiwi_iq_wav(filename: str | Path, z: np.ndarray, samplerate: int,
                      frame_len: int = 512, gps_start: float = 1000.0,
                      true_rate: float | None = None,
                      gps_jitter_s: np.ndarray | None = None) -> None:
    """Write a KiwiSDR-format IQ WAV (tests / capture tool).

    `true_rate` lets tests emulate clock drift: GNSS timestamps advance at
    frame_len/true_rate even though the header claims `samplerate`.
    `gps_jitter_s` (per-frame seconds, off-air GPS solution jitter)
    adds to each frame's timestamp — the reader's EWMA rate estimator
    (reference kiwi/wavreader.py:88-90) must smooth through it.
    """
    true_rate = true_rate or samplerate
    zi = np.empty(2 * len(z), np.int16)
    scaled = np.asarray(z) * 65535.0
    zi[0::2] = np.round(scaled.real).astype(np.int32).clip(-32768, 32767)
    zi[1::2] = np.round(scaled.imag).astype(np.int32).clip(-32768, 32767)

    body = bytearray()
    body += b"WAVE"
    fmt = struct.pack("<HHLLHH", 1, 2, samplerate, samplerate * 4, 4, 16)
    body += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    gps = gps_start
    for k, i in enumerate(range(0, len(z), frame_len)):
        seg = zi[2 * i: 2 * (i + frame_len)]
        g = gps
        if gps_jitter_s is not None:
            g = gps + float(gps_jitter_s[k % len(gps_jitter_s)])
        kiwi = struct.pack("<BBII", 255, 0, int(g), int((g % 1) * 1e9))
        body += b"kiwi" + struct.pack("<I", len(kiwi)) + kiwi
        body += b"data" + struct.pack("<I", len(seg) * 2) + seg.tobytes()
        gps += (len(seg) // 2) / true_rate
    out = b"RIFF" + struct.pack("<I", len(body)) + bytes(body)
    Path(filename).write_bytes(out)


class AudioRecorder:
    """Buffers played audio and writes an int16 WAV on stop (behavior of
    `audio_recording`, utils_supersdr.py:144-172). Mono [n] frames write
    a 1-channel file; stereo [n, 2] frames (the dual-RX mix) write a
    2-channel file."""

    def __init__(self, audio_rate: int = 48000):
        self.audio_rate = audio_rate
        self.frames: list[np.ndarray] = []
        self.recording = False
        self.filename: str | None = None

    def start(self, filename: str | None = None) -> str:
        from datetime import datetime, timezone
        if filename is None:
            stamp = (datetime.now(timezone.utc).isoformat().split(".")[0]
                     .replace(":", "_"))
            filename = f"supersdr_{stamp}UTC.wav"
        self.filename = filename
        self.frames = []
        self.recording = True
        return filename

    def append(self, samples: np.ndarray) -> None:
        if self.recording:
            self.frames.append(np.asarray(samples))

    def stop(self) -> str | None:
        self.recording = False
        if self.filename is None:
            return None
        self.save(self.filename)
        return self.filename

    def save(self, filename: str | Path) -> None:
        data = (np.concatenate(self.frames) if self.frames
                else np.zeros(0, np.float32))
        if data.dtype != np.int16:
            data = np.clip(np.round(data * 32767), -32768, 32767).astype(np.int16)
        channels = data.shape[1] if data.ndim == 2 else 1
        with wave.open(str(filename), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(self.audio_rate)
            w.writeframes(data.tobytes())


def read_audio_wav(filename: str | Path) -> tuple[np.ndarray, int]:
    with wave.open(str(filename), "rb") as w:
        rate = w.getframerate()
        data = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels())
    return data, rate
