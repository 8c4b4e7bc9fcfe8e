"""Fake KiwiSDR server for protocol tests and offline development.

Speaks enough of the KiwiSDR websocket protocol to exercise the full
client: handshake, auth, MSG negotiation (audio_init / center_freq /
wf_fft_size), SET command handling (mod, agc, zoom, compression, …), SND
audio / IQ frame streaming from a supplied generator, W/F row streaming,
and injectable failure modes (too_busy / down / badp) — per SURVEY.md §4's
"protocol tests without a real Kiwi".
"""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass, field

import numpy as np

from supersdr_tpu_torch.io import kiwi_protocol as kp
from supersdr_tpu_torch.io import websocket
from supersdr_tpu_torch.ops import adpcm


@dataclass
class FakeKiwiConfig:
    audio_rate: int = 12000
    audio_rate_true: float = 12001.15
    max_freq_hz: int = 30_000_000
    wf_bins: int = 1024
    max_zoom: int = 14
    max_fps: int = 23
    password: str = ""
    frame_samples: int = 512
    # failure injection
    too_busy: bool = False
    down: bool = False
    # payload sources
    iq_source: np.ndarray | None = None       # complex IQ for mod=iq
    audio_source: np.ndarray | None = None    # int16 audio otherwise
    wf_source: np.ndarray | None = None       # [rows, wf_bins] uint8
    n_frames: int = 32                        # frames to stream then close


class FakeKiwiServer:
    """One-connection-at-a-time threaded server; records every SET command
    it receives in `self.commands` for assertions."""

    def __init__(self, config: FakeKiwiConfig | None = None):
        self.config = config or FakeKiwiConfig()
        self.commands: list[str] = []
        self.state: dict[str, str] = {}
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)

    def start(self) -> "FakeKiwiServer":
        self._thread.start()
        return self

    def wait_state(self, key: str, timeout: float = 2.0) -> str:
        """Block until a SET command has recorded `key` (test helper: the
        client's control burst is async with respect to frame delivery)."""
        import time as _time
        deadline = _time.monotonic() + timeout
        while key not in self.state and _time.monotonic() < deadline:
            _time.sleep(0.01)
        return self.state[key]

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------------

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._handle, args=(conn,), daemon=True)
            t.start()

    def _drain_sets(self, ws: websocket.WebSocket, until: int = 1) -> None:
        """Read client SET commands; non-blockingly best-effort."""
        ws.sock.settimeout(0.02)
        try:
            while True:
                raw = ws.receive()
                if raw is None:
                    return
                self._record(raw)
        except (TimeoutError, OSError):
            pass
        finally:
            ws.sock.settimeout(None)

    def _record(self, raw: bytes) -> None:
        text = raw.decode("utf-8", errors="replace")
        self.commands.append(text)
        if text.startswith("SET "):
            for pair in text[4:].split(" "):
                if "=" in pair:
                    k, v = pair.split("=", 1)
                    self.state[k] = v

    def _handle(self, conn: socket.socket) -> None:
        cfg = self.config
        try:
            ws, resource = websocket.server_handshake(conn)
            stream_type = resource.rsplit("/", 1)[-1]

            # wait for auth
            raw = ws.receive()
            if raw is None:
                return
            self._record(raw)
            if cfg.too_busy:
                ws.send(kp.build_msg(too_busy=4))
                ws.close()
                return
            if cfg.down:
                ws.send(kp.build_msg(down="1"))
                ws.close()
                return
            auth_ok = f"p={cfg.password} " in self.commands[-1] + " "
            ws.send(kp.build_msg(badp="0" if auth_ok else "1"))
            if not auth_ok:
                ws.close()
                return

            if stream_type == "SND":
                self._serve_snd(ws)
            else:
                self._serve_wf(ws)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_snd(self, ws: websocket.WebSocket) -> None:
        cfg = self.config
        ws.send(kp.build_msg(audio_init="0", audio_rate=str(cfg.audio_rate),
                             sample_rate=f"{cfg.audio_rate_true:.3f}"))
        # wait for the client's control burst (SET mod=...) before choosing
        # the payload format — real kiwis likewise only stream after setup
        import time as _time
        deadline = _time.monotonic() + 2.0
        while "mod" not in self.state and _time.monotonic() < deadline:
            self._drain_sets(ws)
        mode = self.state.get("mod", "am")
        comp = self.state.get("compression", "0") == "1"
        enc_state = adpcm.AdpcmState()
        n = cfg.frame_samples
        for seq in range(cfg.n_frames):
            if mode == "iq" and cfg.iq_source is not None:
                z = cfg.iq_source[(seq * n) % max(len(cfg.iq_source) - n, 1):]
                z = z[:n]
                frame = kp.build_snd_iq(seq, -60.0, z * 32767.0,
                                        gpssec=seq, gpsnsec=0)
            else:
                src = cfg.audio_source
                if src is None:
                    t = (np.arange(n) + seq * n) / cfg.audio_rate
                    src_block = (8000 * np.sin(2 * np.pi * 700 * t)).astype(np.int16)
                else:
                    start = (seq * n) % max(len(src) - n, 1)
                    src_block = np.asarray(src[start:start + n], np.int16)
                if comp:
                    payload = adpcm.encode_np(src_block, enc_state)
                    frame = kp.build_snd(seq, -60.0, payload)
                else:
                    frame = kp.build_snd_audio(seq, -60.0, src_block)
            ws.send(frame)
            self._drain_sets(ws)
        # grace period so a slower client can drain buffered frames before
        # the close lands (a hard close + client writes would RST the queue)
        import time as _time
        _time.sleep(0.3)
        ws.close()

    def _serve_wf(self, ws: websocket.WebSocket) -> None:
        cfg = self.config
        ws.send(kp.build_msg(center_freq=str(cfg.max_freq_hz // 2),
                             bandwidth=str(cfg.max_freq_hz)))
        ws.send(kp.build_msg(wf_fft_size=str(cfg.wf_bins), wf_fps="23",
                             wf_fps_max=str(cfg.max_fps),
                             zoom_max=str(cfg.max_zoom)))
        self._drain_sets(ws)
        rows = cfg.wf_source
        if rows is None:
            rng = np.random.default_rng(0)
            rows = rng.integers(120, 220, (cfg.n_frames, cfg.wf_bins),
                                dtype=np.uint8)
        for seq in range(min(cfg.n_frames, len(rows))):
            ws.send(kp.build_wf(seq, rows[seq]))
            self._drain_sets(ws)
        ws.close()
