"""KiwiSDR HTTP /status probe — the pre-connect health gate.

Behavior of `kiwi_sdr.__init__` (utils_supersdr.py:550-590):
fetch `http://host:port/status`, parse key=value lines, and gate the
connection on users==users_max ("too many users") or offline/inactive.
"""

from __future__ import annotations

import urllib.request
from dataclasses import dataclass

from supersdr_tpu_torch.io.kiwi_protocol import parse_status_page


class KiwiGateError(Exception):
    pass


class KiwiBusy(KiwiGateError):
    pass


class KiwiOffline(KiwiGateError):
    pass


@dataclass
class KiwiStatus:
    users: int = 0
    users_max: int = 4
    active: bool = True
    offline: bool = False
    gps: tuple[float, float] | None = None
    name: str = ""
    antenna: str = ""
    qth: str = ""
    min_freq_khz: float = 0.0
    max_freq_khz: float = 30000.0
    freq_offset_hz: float = 0.0
    raw: dict | None = None

    @classmethod
    def from_text(cls, text: str) -> "KiwiStatus":
        d = parse_status_page(text)
        st = cls(raw=d)
        st.users = int(d.get("users", 0))
        st.users_max = int(d.get("users_max", 4))
        st.active = d.get("status", "active") in ("active", "private")
        st.offline = d.get("offline", "no") != "no"
        st.name = d.get("name", "")
        st.antenna = d.get("antenna", "")
        st.qth = d.get("loc", "")
        if "gps" in d:
            try:
                lat, lon = d["gps"].split(", ")
                st.gps = (float(lat[1:]), float(lon[:-1]))
            except (ValueError, IndexError):
                st.gps = None
        if "bands" in d:
            try:
                lo, hi = d["bands"].split("-")
                st.min_freq_khz, st.max_freq_khz = float(lo), float(hi)
            except ValueError:
                pass
        try:
            st.freq_offset_hz = float(d.get("freq_offset", 0))
        except ValueError:
            st.freq_offset_hz = 0.0
        return st

    @classmethod
    def fetch(cls, host: str, port: int, timeout: float = 5.0) -> "KiwiStatus":
        url = f"http://{host}:{port}/status"
        with urllib.request.urlopen(url, timeout=timeout) as f:
            return cls.from_text(f.read().decode("utf-8", errors="replace"))

    def gate(self) -> None:
        """Raise if the server should not be connected to
        (utils_supersdr.py:648-657,948-956)."""
        if self.users >= self.users_max:
            raise KiwiBusy(f"too many users ({self.users}/{self.users_max})")
        if self.offline or not self.active:
            raise KiwiOffline("KiwiSDR offline or under maintenance")
