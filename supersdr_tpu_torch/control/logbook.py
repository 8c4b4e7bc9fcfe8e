"""QSO logbook: CSV-persisted contact log with search.

Headless replacement for the reference's tkinter `logger` dialogs
(utils_supersdr.py:1829-2093): entries carry UTC date/time,
callsign, frequency, mode, signal reports and a comment, appended to a
semicolon-separated log file (`log.sdr` format family)."""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from datetime import datetime, timezone
from pathlib import Path

FIELDS = ["date", "utc", "callsign", "freq_khz", "mode", "rst_sent",
          "rst_rcvd", "comment"]


@dataclass
class QSO:
    callsign: str
    freq_khz: float
    mode: str
    rst_sent: str = "59"
    rst_rcvd: str = "59"
    comment: str = ""
    date: str = ""
    utc: str = ""

    def __post_init__(self):
        if not self.date or not self.utc:
            now = datetime.now(timezone.utc)
            self.date = self.date or now.strftime("%Y-%m-%d")
            self.utc = self.utc or now.strftime("%H:%M")


class Logbook:
    def __init__(self, path: str | Path = "log.sdr"):
        self.path = Path(path)
        self.qsos: list[QSO] = []
        self.load()

    def load(self) -> None:
        self.qsos = []
        try:
            lines = self.path.read_text().splitlines()
        except OSError:
            return
        for line in lines:
            parts = line.split(";")
            if len(parts) < 5 or parts[0] == "date":
                continue
            try:
                self.qsos.append(QSO(date=parts[0], utc=parts[1],
                                     callsign=parts[2],
                                     freq_khz=float(parts[3]), mode=parts[4],
                                     rst_sent=parts[5] if len(parts) > 5 else "",
                                     rst_rcvd=parts[6] if len(parts) > 6 else "",
                                     comment=parts[7] if len(parts) > 7 else ""))
            except ValueError:
                continue

    def add(self, qso: QSO) -> None:
        self.qsos.append(qso)
        line = ";".join([qso.date, qso.utc, qso.callsign,
                         f"{qso.freq_khz:.3f}", qso.mode, qso.rst_sent,
                         qso.rst_rcvd, qso.comment])
        with self.path.open("a") as fd:
            fd.write(line + "\n")

    def search(self, callsign: str) -> list[QSO]:
        needle = callsign.upper()
        return [q for q in self.qsos if needle in q.callsign.upper()]

    def __len__(self):
        return len(self.qsos)
