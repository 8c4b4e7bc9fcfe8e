"""NCDXF/IARU beacon scheduler.

Behavior of the reference `beacons` class (
utils_supersdr.py:2096-2129): 18 beacons rotate across 5 bands in 10-second
slots over a 3-minute cycle."""

from __future__ import annotations

from datetime import datetime, timedelta, timezone

BEACON_CALLS = ["4U1UN", "VE8AT", "W6WX", "KH6WO", "ZL6B", "VK6RBP",
                "JA2IGY", "RR9O", "VR2B", "4S7B", "ZS6DN", "5Z4B", "4X6TU",
                "OH2B", "CS3B", "LU4AA", "OA4B", "YV5B"]
BANDS = [14, 18, 21, 24, 28]
FREQ_KHZ = {14: 14100, 18: 18110, 21: 21150, 24: 24930, 28: 28200}


def which_beacons(now: datetime | None = None) -> dict[int, str]:
    """Band → callsign currently transmitting."""
    now = now or datetime.now(timezone.utc)
    delta_seconds = timedelta(minutes=now.minute % 3,
                              seconds=now.second).total_seconds()
    index = int(delta_seconds // 10)
    return {band: BEACON_CALLS[(index - i) % len(BEACON_CALLS)]
            for i, band in enumerate(BANDS)}
