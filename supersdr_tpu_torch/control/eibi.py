"""EIBI shortwave schedule database.

Behavior of `eibi_db` (utils_supersdr.py:1321-1360): loads
the semicolon-separated `eibi.csv` (latin-1), indexes stations by integer
kHz for span queries, and filters by on-air time at lookup (the reference
applies the HHMM-HHMM window at render, utils:1703-1706)."""

from __future__ import annotations

from collections import defaultdict
from datetime import datetime, timezone
from pathlib import Path


DEFAULT_EIBI_PATH = Path(__file__).parent.parent / "data" / "eibi.csv"


class EibiDb:
    def __init__(self, path: str | Path | None = None):
        """Load `eibi.csv`; with no path, try ./eibi.csv then the copy
        shipped in supersdr_tpu_torch/data/ (public EIBI schedule data,
        as the reference ships it in its repo root)."""
        self.station_dict: dict[float, list[list[str]]] = defaultdict(list)
        self.int_freq_dict: dict[int, list[float]] = defaultdict(list)
        self.visible_stations: list[float] = []
        self.loaded = False
        candidates = ([Path(path)] if path is not None
                      else [Path("eibi.csv"), DEFAULT_EIBI_PATH])
        data = None
        for p in candidates:
            try:
                data = p.read_text(encoding="latin-1").splitlines()
                break
            except OSError:
                continue
        if data is None:
            return
        for line in data[1:]:
            els = line.rstrip().split(";")
            try:
                f = float(els[0])
            except (ValueError, IndexError):
                continue
            self.int_freq_dict[int(round(f))].append(f)
            self.station_dict[f].append(els[1:])
        self.freq_set = set(self.int_freq_dict.keys())
        self.loaded = True

    def get_stations(self, start_f_khz: float, end_f_khz: float) -> list[float]:
        """Frequencies with scheduled stations inside the span."""
        if not self.loaded:
            return []
        inters = set(range(int(start_f_khz), int(end_f_khz))) & self.freq_set
        self.visible_stations = [f for i in inters
                                 for f in self.int_freq_dict[i]]
        return self.visible_stations

    def get_names(self, f_khz: float) -> list[str]:
        return [rec[3] for rec in self.station_dict.get(f_khz, [])
                if len(rec) > 3]

    @staticmethod
    def on_air(record: list[str], now: datetime | None = None) -> bool:
        """HHMM-HHMM on-air window check (utils:1703-1706)."""
        try:
            tspan = record[0]
            start = int(tspan[:2]) + int(tspan[2:4]) / 60
            stop = int(tspan[5:7]) + int(tspan[7:9]) / 60
        except (ValueError, IndexError):
            return True
        now = now or datetime.now(timezone.utc)
        t = now.hour + now.minute / 60
        return start <= t <= stop

    def get_on_air(self, start_f_khz: float, end_f_khz: float,
                   now: datetime | None = None) -> list[tuple[float, str]]:
        """(freq, name) pairs currently broadcasting inside the span."""
        out = []
        for f in sorted(set(self.get_stations(start_f_khz, end_f_khz))):
            for rec in self.station_dict[f]:
                if len(rec) > 3 and self.on_air(rec, now):
                    out.append((f, rec[3]))
        return out
