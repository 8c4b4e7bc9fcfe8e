"""KiwiSDR wire protocol: message grammar and binary frame layouts.

Pure build/parse functions — no sockets — so the protocol is testable
against byte fixtures and reusable by both the live client and the fake
server. Grammar and layouts per the reference:

  client→server text commands  utils_supersdr.py:741-742,976-983
  server→client MSG params     kiwi/client.py:313-355, utils_supersdr.py:675-689,984-994
  SND frame                    utils_supersdr.py:1066-1072 (3B tag 'SND',
                               u8 flags, u32LE seq, u16BE s-meter, payload:
                               big-endian int16 audio | ADPCM | 10B GPS
                               header + big-endian IQ pairs)
  W/F frame                    kiwi/client.py:470-482 + utils_supersdr.py:783
                               (3B tag 'W/F', 1B pad, u32LE x_bin,
                               u32LE flags/zoom, u32LE seq, uint8 bins)
"""

from __future__ import annotations

import struct
import urllib.parse
from dataclasses import dataclass

import numpy as np

SND_TAG = b"SND"
WF_TAG = b"W/F"
MSG_TAG = b"MSG"

ADC_OVERFLOW_FLAG = 0x02


# ---------------------------------------------------------------- builders

def auth(password: str = "") -> str:
    return f"SET auth t=kiwi p={password} ipl={password}"


def ident_user(name: str) -> str:
    return f"SET ident_user={name}"


def set_mod(mode: str, low_cut: int, high_cut: int, freq_khz: float) -> str:
    return "SET mod=%s low_cut=%d high_cut=%d freq=%.3f" % (
        mode.lower(), low_cut, high_cut, freq_khz)


def set_agc(on: bool, hang: bool, thresh: int, slope: int, decay: int,
            gain: int) -> str:
    return "SET agc=%d hang=%d thresh=%d slope=%d decay=%d manGain=%d" % (
        int(on), int(hang), thresh, slope, decay, gain)


def set_squelch(sq: int, thresh: int) -> str:
    return f"SET squelch={sq} max={thresh}"


def set_noise_blanker(gate: int, thresh: int) -> str:
    return f"SET nb={gate} th={thresh}"


def set_compression(comp: bool) -> str:
    return f"SET compression={int(comp)}"


def set_ar_ok(ar_in: int, ar_out: int) -> str:
    return f"SET AR OK in={ar_in} out={ar_out}"


def set_zoom_start(zoom: int, counter: float) -> str:
    return "SET zoom=%d start=%d" % (zoom, counter)


def set_zoom_cf(zoom: int, cf_khz: float) -> str:
    return "SET zoom=%d cf=%f" % (zoom, cf_khz)


def set_maxdb_mindb(maxdb: int, mindb: int) -> str:
    return f"SET maxdb={maxdb} mindb={mindb}"


def set_wf_speed(speed: int) -> str:
    return f"SET wf_speed={speed}"


def set_wf_comp(comp: bool) -> str:
    return f"SET wf_comp={int(comp)}"


def set_wf_interp(interp: int) -> str:
    return f"SET interp={interp}"


def set_inactivity_override(timeout: int = 1000) -> str:
    return f"SET OVERRIDE inactivity_timeout={timeout}"


def keepalive() -> str:
    return "SET keepalive"


# ----------------------------------------------------------------- frames

@dataclass
class SndFrame:
    flags: int
    seq: int
    rssi: float          # 0.1 * smeter - 127 (utils_supersdr.py:1069)
    payload: bytes

    @property
    def adc_overflow(self) -> bool:
        return bool(self.flags & ADC_OVERFLOW_FLAG)

    def audio_int16(self) -> np.ndarray:
        """Uncompressed mono audio: big-endian int16."""
        return np.frombuffer(self.payload, dtype=">h").astype(np.int16)

    def iq_samples(self) -> tuple[dict, np.ndarray]:
        """IQ mode: 10-byte GPS header then big-endian int16 I/Q pairs
        (kiwi/client.py:443-454)."""
        sol, dummy, gpssec, gpsnsec = struct.unpack("<BBII", self.payload[:10])
        gps = {"last_gps_solution": sol, "dummy": dummy,
               "gpssec": gpssec, "gpsnsec": gpsnsec}
        s = np.frombuffer(self.payload[10:], dtype=">h").astype(np.float32)
        z = np.empty(len(s) // 2, np.complex64)
        z.real = s[0::2]
        z.imag = s[1::2]
        return gps, z

    def iq_samples_i16(self) -> tuple[dict, np.ndarray, np.ndarray]:
        """IQ mode, INT16-plane form: (gps, re_i16, im_i16) — the wire
        samples stay int16 (full-scale ±32768 ≡ ±1.0), device-ready for
        the wideband pipeline's i16 ingest (`process_i16`) with HALF
        the host→device bytes of the complex64 form. Native
        deinterleave when the sdrkit library is available."""
        sol, dummy, gpssec, gpsnsec = struct.unpack("<BBII", self.payload[:10])
        gps = {"last_gps_solution": sol, "dummy": dummy,
               "gpssec": gpssec, "gpsnsec": gpsnsec}
        from supersdr_tpu_torch import native
        out = native.be16_iq_split_i16(self.payload[10:])
        if out is not None:
            return gps, out[0], out[1]
        s = np.frombuffer(self.payload[10:], dtype=">h")
        return gps, s[0::2].astype(np.int16), s[1::2].astype(np.int16)


@dataclass
class WfFrame:
    x_bin: int
    flags_zoom: int
    seq: int
    payload: bytes

    def bins_uint8(self) -> np.ndarray:
        return np.frombuffer(self.payload, dtype=np.uint8)


@dataclass
class Msg:
    params: dict[str, str | None]


def parse(frame: bytes) -> SndFrame | WfFrame | Msg | None:
    """Parse one websocket binary message from a KiwiSDR."""
    tag = frame[:3]
    if tag == SND_TAG:
        flags, seq = struct.unpack("<BI", frame[3:8])
        (smeter,) = struct.unpack(">H", frame[8:10])
        return SndFrame(flags=flags, seq=seq, rssi=0.1 * smeter - 127,
                        payload=frame[10:])
    if tag == WF_TAG:
        x_bin, fz, seq = struct.unpack("<III", frame[4:16])
        return WfFrame(x_bin=x_bin, flags_zoom=fz, seq=seq, payload=frame[16:])
    if tag == MSG_TAG:
        body = frame[4:].decode("utf-8", errors="replace")
        params: dict[str, str | None] = {}
        for pair in body.split(" "):
            if "=" in pair:
                k, v = pair.split("=", 1)
                params[k] = v
            elif pair:
                params[pair] = None
        return Msg(params=params)
    return None


def build_snd(seq: int, rssi: float, payload: bytes, flags: int = 0) -> bytes:
    smeter = int(np.clip(round((rssi + 127.0) * 10.0), 0, 65535))
    return (SND_TAG + struct.pack("<BI", flags, seq)
            + struct.pack(">H", smeter) + payload)


def build_snd_audio(seq: int, rssi: float, samples: np.ndarray,
                    flags: int = 0) -> bytes:
    return build_snd(seq, rssi, np.asarray(samples, np.int16)
                     .astype(">h").tobytes(), flags)


def build_snd_iq(seq: int, rssi: float, z: np.ndarray, gpssec: int = 0,
                 gpsnsec: int = 0, solution: int = 255, flags: int = 0) -> bytes:
    hdr = struct.pack("<BBII", solution, 0, gpssec, gpsnsec)
    s = np.empty(2 * len(z), np.int16)
    s[0::2] = np.round(np.real(z)).astype(np.int32).clip(-32768, 32767)
    s[1::2] = np.round(np.imag(z)).astype(np.int32).clip(-32768, 32767)
    return build_snd(seq, rssi, hdr + s.astype(">h").tobytes(), flags)


def build_wf(seq: int, bins: np.ndarray, x_bin: int = 0,
             flags_zoom: int = 0) -> bytes:
    return (WF_TAG + b"\x00" + struct.pack("<III", x_bin, flags_zoom, seq)
            + np.asarray(bins, np.uint8).tobytes())


def build_msg(**params) -> bytes:
    body = " ".join(k if v is None else f"{k}={v}" for k, v in params.items())
    return MSG_TAG + b" " + body.encode()


def parse_status_page(text: str) -> dict[str, str]:
    """Parse the HTTP /status page key=value lines
    (utils_supersdr.py:564-570)."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if "=" in line:
            k, v = line.split("=", 1)
            out[k] = v
    return out


def unquote(value: str) -> str:
    return urllib.parse.unquote(value)
