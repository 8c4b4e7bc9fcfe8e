"""DX cluster client: spot ingest, TTL expiry, span filtering, dedup.

Behavior of the reference `dxcluster` (
utils_supersdr.py:175-330): telnet to a cluster node (default
dxfun.com:8000), login with the user's callsign, parse "DX de ..." lines,
store spots with a 50-minute TTL, age-bucketed display colors, per-span
visible list with newest-spot-wins dedup per callsign. The socket is
injectable so tests feed canned traffic."""

from __future__ import annotations

import itertools
import socket
import threading
from datetime import datetime, timezone

CLEANUP_TIME = 120
UPDATE_TIME = 10
SPOT_TTL_BASETIME = 600
TTL_SECONDS = SPOT_TTL_BASETIME * 5

AGE_COLORS = {0: "green", SPOT_TTL_BASETIME: "yellow",
              SPOT_TTL_BASETIME * 2: "orange", SPOT_TTL_BASETIME * 3: "red",
              SPOT_TTL_BASETIME * 4: "grey"}

DEFAULT_SERVER = ("dxfun.com", 8000)


def decode_spot(line: str):
    """Parse one 'DX de SPOTTER: freq CALL ...' line → (freq_khz, callsign,
    spotter) or None (decode_spot semantics, utils:241-255)."""
    els = [x for x in line.split("  ") if x]
    try:
        spotter = els[0][6:].split(":")[0]
        qrg = float(els[1].strip())
        callsign = els[2].strip()
        return qrg, callsign, spotter
    except (IndexError, ValueError):
        return None


def age_color(age_seconds: float) -> str:
    best = "grey"
    for threshold in sorted(AGE_COLORS):
        if age_seconds >= threshold:
            best = AGE_COLORS[threshold]
    return best


class DxCluster:
    def __init__(self, mycall: str, server=DEFAULT_SERVER, sock=None):
        if not mycall:
            raise ValueError("a callsign is required to log into a cluster")
        self.mycall = mycall
        self.server = server
        self.sock = sock
        self.spot_dict: dict[int, tuple] = {}
        self.visible_stations: list[int] = []
        self.terminate = False
        self.update_now = False
        self._ids = itertools.count()
        self._lock = threading.Lock()

    # ------------------------------------------------------- networking

    def connect(self, timeout: float = 10.0) -> None:
        if self.sock is None:
            self.sock = socket.create_connection(self.server, timeout=timeout)
        self.sock.sendall((self.mycall + "\n").encode())

    def disconnect(self) -> None:
        self.terminate = True
        if self.sock is not None:
            try:
                self.sock.shutdown(socket.SHUT_WR)
                self.sock.close()
            except OSError:
                pass

    # --------------------------------------------------------- ingest

    def feed(self, text: str, now: datetime | None = None) -> int:
        """Parse incoming cluster text; returns number of spots stored."""
        now = now or datetime.now(timezone.utc)
        stored = 0
        for line in text.replace("\x07", "").split("\n"):
            if "DX de " not in line:
                continue
            dec = decode_spot(line)
            if dec is None:
                continue
            qrg, callsign, spotter = dec
            with self._lock:
                self.spot_dict[next(self._ids)] = (callsign, qrg, now, spotter)
            stored += 1
        if stored:
            self.update_now = True
        return stored

    def clean_old_spots(self, now: datetime | None = None) -> None:
        now = now or datetime.now(timezone.utc)
        with self._lock:
            dead = [sid for sid, (_, _, utc, _) in self.spot_dict.items()
                    if (now - utc).total_seconds() > TTL_SECONDS]
            for sid in dead:
                del self.spot_dict[sid]

    # --------------------------------------------------------- queries

    def get_stations(self, start_f_khz: float, end_f_khz: float
                     ) -> list[int]:
        """Visible spot ids in the span, frequency-sorted, older duplicate
        callsigns dropped (get_stations semantics, utils:308-325)."""
        with self._lock:
            by_call: dict[str, list[int]] = {}
            vis = []
            for sid, (call, qrg, utc, _) in self.spot_dict.items():
                if start_f_khz < qrg < end_f_khz:
                    by_call.setdefault(call, []).append(sid)
                    vis.append(sid)
            for call, sids in by_call.items():
                if len(sids) > 1:
                    keep_order = sorted(sids,
                                        key=lambda s: self.spot_dict[s][2])
                    for sid in keep_order[:-1]:
                        vis.remove(sid)
                        del self.spot_dict[sid]
            self.visible_stations = sorted(
                vis, key=lambda s: self.spot_dict[s][1])
            return self.visible_stations

    def spot(self, sid: int) -> tuple:
        return self.spot_dict[sid]

    # ------------------------------------------------------- run loop

    def run(self, span_provider=None, poll_timeout: float = 1.0) -> None:
        """Background ingest loop (thread target). `span_provider` returns
        (start_khz, end_khz) for visible-list refreshes."""
        self.connect()
        self.sock.settimeout(poll_timeout)
        last_cleanup = last_update = datetime.now(timezone.utc)
        while not self.terminate:
            try:
                msg = self.sock.recv(2048)
            except TimeoutError:
                msg = b""
            except OSError:
                break
            if msg:
                self.feed(msg.decode("utf-8", errors="replace"))
            now = datetime.now(timezone.utc)
            if (now - last_cleanup).total_seconds() > CLEANUP_TIME:
                try:
                    self.sock.sendall(chr(8).encode())
                except OSError:
                    pass
                self.clean_old_spots(now)
                last_cleanup = now
            if span_provider and ((now - last_update).total_seconds()
                                  > UPDATE_TIME or self.update_now):
                start, end = span_provider()
                self.get_stations(start, end)
                last_update = now
                self.update_now = False
