"""Headless panadapter raster: spectrum scope + waterfall → RGB array.

Reproduces the data semantics of the reference renderer
(`display_stuff.plot_spectrum` utils_supersdr.py:1669-1691 — the scope is
the mean of the newest 15 waterfall rows; the waterfall blits color rows
through the palette) as pure numpy raster composition, writable to PNG.
"""

from __future__ import annotations

import numpy as np

from supersdr_tpu_torch.display import colormap as cm


def render_waterfall(color_history: np.ndarray,
                     palette_name: str = "cutesdr") -> np.ndarray:
    """[rows, bins] 0..255 color values → [rows, bins, 3] uint8."""
    pal = cm.get_palette(palette_name)
    return cm.apply(pal, color_history)


def render_spectrum(color_history: np.ndarray, height: int = 150,
                    n_avg_rows: int = 15, filled: bool = True,
                    color=(200, 180, 0)) -> np.ndarray:
    """Scope trace raster from the newest rows of the waterfall history
    (utils:1678 mean-of-15)."""
    rows = np.asarray(color_history)[:n_avg_rows]
    trace = rows.mean(axis=0) / 255.0            # [bins] 0..1
    bins = trace.shape[0]
    img = np.zeros((height, bins, 3), np.uint8)
    y = ((1.0 - trace) * (height - 1)).astype(int)
    col = np.asarray(color, np.uint8)
    x = np.arange(bins)
    if filled:
        mask = np.arange(height)[:, None] >= y[None, :]
        img[mask] = col // 2
    img[y, x] = col
    return img


def render_smeter(rssi_db: float, width: int = 256, height: int = 24
                  ) -> np.ndarray:
    """S-meter bar raster: S1..S9 then +10/+20/+30 dB over, with the
    standard S9 = -73 dBm convention (the data behind the reference's
    analog dial, utils:1607-1667). Green to S9, red beyond."""
    img = np.zeros((height, width, 3), np.uint8)
    img[:] = (25, 25, 25)
    # scale: -127 dBm (S0) .. -13 dBm (S9+60); S9 at -73
    frac = np.clip((rssi_db + 127.0) / 114.0, 0.0, 1.0)
    fill = int(frac * (width - 4))
    s9_x = int((-73.0 + 127.0) / 114.0 * (width - 4))
    for x in range(fill):
        color = (0, 200, 0) if x <= s9_x else (220, 40, 40)
        img[3:-3, 2 + x] = color
    # tick marks each S-unit up to S9, then each 10 dB
    for s in range(10):
        x = 2 + int((s * 6.0) / 114.0 * (width - 4))
        img[:3, x] = (200, 200, 200)
    for over in (10, 20, 30, 40, 50, 60):
        x = 2 + int((54.0 + over) / 114.0 * (width - 4))
        img[:3, x] = (255, 180, 0)
    return img


EIBI_MARKER = (80, 220, 80)      # reference station labels, utils:1693-1729
DX_MARKER = (80, 200, 220)       # dx-cluster spots, utils:1755-1786
BEACON_MARKER = (255, 160, 0)    # NCDXF beacons, utils:1787-1804


def render_panadapter(color_history: np.ndarray, spectrum_height: int = 150,
                      palette_name: str = "cutesdr",
                      tick_bins: list[int] | None = None,
                      markers: list[tuple[int, tuple[int, int, int]]]
                      | None = None) -> np.ndarray:
    """Full headless panadapter frame: scope on top, tick bar, waterfall.

    `markers`: (bin, rgb) station/spot/beacon positions drawn as wider
    stubs on the tick bar (the headless analog of the reference's overlay
    labels, utils:1693-1804)."""
    wf = render_waterfall(color_history, palette_name)
    spec = render_spectrum(color_history, height=spectrum_height)
    bins = wf.shape[1]
    bar = np.zeros((8, bins, 3), np.uint8)
    bar[:] = (40, 40, 40)
    if tick_bins:
        for b in tick_bins:
            if 0 <= b < bins:
                bar[:, b] = (255, 255, 255)
    if markers:
        for b, rgb in markers:
            if 0 <= b < bins:
                bar[2:, max(0, b - 1): b + 2] = rgb
    return np.concatenate([spec, bar, wf], axis=0)
