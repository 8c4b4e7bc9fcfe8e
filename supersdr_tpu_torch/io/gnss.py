"""GNSS time alignment for live IQ streams (TDoA-grade timestamps).

The KiwiSDR attaches a GPS timestamp header to every IQ SND frame
(last_gps_solution, gpssec, gpsnsec — kiwi/client.py:443-454); the
reference only surfaces them in recorded WAVs, where the reader estimates
the true sample rate from consecutive GNSS seconds (kiwi/wavreader.py:
83-90). This utility applies the same EWMA rate estimation to the *live*
stream, yielding per-sample absolute times — what multi-receiver TDoA
pipelines need from each ingest host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GnssTimekeeper:
    """Streaming true-rate estimator + absolute-time stamper.

    Same semantics as the WAV reader: frames 0-2 seed the instantaneous
    rate, later frames blend 0.9·old + 0.1·new; timestamps are emitted
    once settled (frame ≥ 2). GPS week rollovers (gpssec wrapping) are
    unwrapped.
    """
    nominal_rate: float
    rate: float = 0.0
    _last_gpssec: float = -1.0
    _frames: int = 0
    _wrap_offset: float = 0.0
    GPS_WEEK_S: float = 7 * 24 * 3600.0

    def __post_init__(self):
        self.rate = float(self.nominal_rate)

    def update(self, gpssec: int, gpsnsec: int, n_samples: int
               ) -> np.ndarray | None:
        """Feed one frame's GPS header; returns per-sample absolute times
        [n_samples] float64 (None while settling)."""
        gps = gpssec + 1e-9 * gpsnsec + self._wrap_offset
        if self._last_gpssec >= 0 and gps < self._last_gpssec - 1.0:
            # gpssec wrapped (end of GPS week)
            self._wrap_offset += self.GPS_WEEK_S
            gps += self.GPS_WEEK_S
        if self._last_gpssec >= 0:
            dt = gps - self._last_gpssec
            if dt > 0:
                inst = n_samples / dt
                if self._frames < 3:
                    self.rate = inst
                else:
                    self.rate = 0.9 * self.rate + 0.1 * inst
        t = None
        if self._frames >= 2:
            t = gps + np.arange(n_samples, dtype=np.float64) / self.rate
        self._last_gpssec = gps
        self._frames += self._frames < 3
        return t

    @property
    def settled(self) -> bool:
        return self._frames >= 2

    @property
    def drift_ppm(self) -> float:
        return (self.rate / self.nominal_rate - 1.0) * 1e6
