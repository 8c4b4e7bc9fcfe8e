"""RSSI calibration constants (the reference's `ops/smeter.py`)."""

# full-scale (|iq| = 1.0) calibration, dB (typical KiwiSDR waterfall cal)
DEFAULT_CAL_DB = -13.0
RSSI_FLOOR_DB = -127.0
