"""Terminal panadapter: spectrum + waterfall + tuning in a terminal.

The pygame GUI of the reference is replaced by a dependency-free terminal
client with the same keyboard command table where it makes sense
(supersdr.py help list, utils_supersdr.py:73-102):

  ←/→ tune ∓/± 1 kHz   (SHIFT… use </> for ×10)    SPACE  recenter span
  u/l/c/a  USB/LSB/CW/AM        x  auto-mode on/off
  j/k      passband low/high    o  reset passband
  ↑/↓      zoom in/out          g/h  averaging +/-
  v/b      volume +/- 10%       m  mute
  w/r      write/recall memory  q  quit

Split into a pure *model* (state + text-row rendering, unit-testable) and
a thin curses front end. The model consumes waterfall color rows (0..255) and
RSSI from any source — offline WAV playback or a live session.
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass, field

import numpy as np

from supersdr_tpu_torch.control.bandplan import get_auto_mode
from supersdr_tpu_torch.control.memories import MemoryBank
from supersdr_tpu_torch.control.panadapter import Panadapter
from supersdr_tpu_torch.control.receiver import Receiver
from supersdr_tpu_torch.ops import smeter as smeter_ops

# terminal 256-color cube mapping of the cutesdr ramp: dark blue → cyan →
# green → yellow → red, approximated with xterm palette indices
_ANSI_RAMP = [16, 17, 18, 19, 20, 21, 27, 33, 39, 45, 51, 50, 49, 48, 47,
              46, 82, 118, 154, 190, 226, 220, 214, 208, 202, 196]
_BLOCKS = " ▁▂▃▄▅▆▇█"

# reference HELP_MESSAGE_LIST (utils_supersdr.py:73-102), terminal edition
HELP_LINES = [
    "supersdr-tpu TUI keys",
    "  LEFT/RIGHT tune ±1 kHz   </> ±10 kHz   f direct entry (Enter/ESC)",
    "  PGUP/PGDN  span ±SPAN/4  UP/DOWN zoom  SPACE recenter",
    "  u/l/c/a    USB/LSB/CW/AM   x auto-mode   j/k passband  o reset",
    "  g/h        averaging +/-   ,/. high-clip  ;/' low-clip",
    "  v/b        volume ±10 %    m mute        5/6 balance L/R",
    "  y          SUB RX on / switch MAIN-SUB   Y kill SUB   n SUB→center",
    "  w/r        write/recall memory   W save to disk   R clear all",
    "  E          record audio    i EIBI overlay  d DX cluster  s CAT sync",
    "  1/2        AGC threshold -/+   !/@ AGC decay -/+   3 WF autoscale",
    "  0/9        log QSO / search log (callsign entry)   4 spectrum fill",
    "  K          server book (digit connects, auto-revert on failure)",
    "  mouse      click/drag waterfall to tune, wheel zoom,",
    "             drag spectrum row to pan span, SHIFT-drag passband edge",
    "  ?          toggle this help          q quit",
]


def color_to_ansi_index(value: float) -> int:
    """0..255 waterfall color → xterm-256 palette index."""
    i = int(np.clip(value, 0, 255) / 256.0 * len(_ANSI_RAMP))
    return _ANSI_RAMP[min(i, len(_ANSI_RAMP) - 1)]


def resample_bins(row: np.ndarray, width: int) -> np.ndarray:
    """Max-pool waterfall bins down to the terminal width (peaks survive)."""
    bins = len(row)
    edges = np.linspace(0, bins, width + 1).astype(int)
    return np.array([row[a:b].max() if b > a else row[a]
                     for a, b in zip(edges[:-1], edges[1:])])


def spectrum_row_text(row: np.ndarray, width: int, fill: bool = True) -> str:
    """One-line spectrum trace: solid blocks (filled, reference key 4 on)
    or a sparse level gradient (off)."""
    r = resample_bins(row, width) / 255.0
    chars = _BLOCKS if fill else " .,:;|+*#%"
    return "".join(chars[int(v * (len(chars) - 1))] for v in r)


def waterfall_row_ansi(row: np.ndarray, width: int) -> str:
    r = resample_bins(row, width)
    out = []
    prev = None
    for v in r:
        idx = color_to_ansi_index(v)
        if idx != prev:
            out.append(f"\x1b[48;5;{idx}m")
            prev = idx
        out.append(" ")
    out.append("\x1b[0m")
    return "".join(out)


def smeter_text(rssi_db: float, width: int = 24) -> str:
    s = float(smeter_ops.s_units(np.float32(rssi_db)))
    frac = np.clip((rssi_db + 127.0) / 114.0, 0.0, 1.0)
    fill = int(frac * width)
    label = f"S{min(int(s), 9)}" + (f"+{int((s - 9) * 6)}" if s > 9 else "")
    return "[" + "=" * fill + " " * (width - fill) + f"] {label} {rssi_db:5.1f}dB"


@dataclass
class TuiModel:
    """All panadapter/receiver state + text rendering, no curses.

    When a LinkController is attached (`links`), tune/mode/zoom events
    route through it so span-follow, auto-mode, and CAT sync behave as
    the reference main loop (supersdr.py:826-921); standalone (links is
    None) the model drives rx/pan directly.
    """
    rx: Receiver
    pan: Panadapter
    width: int = 100
    wf_height: int = 18
    averaging_n: int = 1
    auto_mode: bool = True
    history: list = field(default_factory=list)
    memories: MemoryBank = field(default_factory=MemoryBank)
    message: str = ""
    links: object = None
    # overlay sources (reference plot_eibi/plot_dxcluster/plot_beacons,
    # utils:1693-1804): lazy EIBI DB, optional dxcluster with
    # get_stations()/spot(), beacon markers ride with EIBI
    show_eibi: bool = False
    show_dx: bool = False
    eibi: object = None
    dx: object = None
    # reference F key: direct frequency entry (digits, Enter commits,
    # ESC cancels — supersdr.py:653-719); E: audio recording toggle;
    # ,/. waterfall clip level deltas (utils:82)
    freq_entry: str = None
    recording: bool = False
    wf_delta_low_db: float = 0.0
    wf_delta_high_db: float = 0.0
    show_help: bool = False
    # reference 0/9 logger keys (supersdr.py logger dialogs → headless
    # entry line), 4 spectrum filling toggle (utils:96)
    text_entry: tuple = None        # (purpose, buffer)
    spectrum_fill: bool = True
    logbook: object = None
    # mouse drag state (reference flags.click_drag_flag/start_drag_x,
    # utils:130-131): (kind, last_col[, which_edge]) or None
    drag: tuple = None
    # render geometry for mouse-row gating (ADVICE r2: clicks outside the
    # spectrum/waterfall surface must not retune) — set by render()
    _spectrum_row: int = None
    _wf_row0: int = None
    _row_shift: int = 0             # extra rows inserted above (SUB line)

    def _get_logbook(self):
        if self.logbook is None:
            from supersdr_tpu_torch.control.logbook import Logbook
            self.logbook = Logbook()
        return self.logbook

    def _commit_text_entry(self) -> None:
        purpose, buf = self.text_entry
        self.text_entry = None
        buf = buf.strip().upper()
        if not buf:
            return
        if purpose == "qso_add":
            from supersdr_tpu_torch.control.logbook import QSO
            book = self._get_logbook()
            book.add(QSO(callsign=buf, freq_khz=self.rx.freq,
                         mode=self.rx.radio_mode))
            self.message = f"logged {buf} @ {self.rx.freq:.1f} kHz"
        elif purpose == "qso_search":
            hits = self._get_logbook().search(buf)
            if hits:
                q = hits[-1]
                self.message = (f"{len(hits)} QSO(s) {buf}: last "
                                f"{q.date} {q.utc} {q.freq_khz:.1f} {q.mode}")
            else:
                self.message = f"no QSOs for {buf}"

    def push_row(self, color_row: np.ndarray) -> None:
        self.history.insert(0, np.asarray(color_row))
        del self.history[self.wf_height:]

    # ------------------------------------------------------- key handling

    def _tune(self, freq_khz: float) -> None:
        if self.links is not None:
            self.links.flags.auto_mode = self.auto_mode
            self.links.manual_tune(freq_khz)
        else:
            self.rx.tune(freq_khz, auto_mode=self.auto_mode)
            self.pan.follow(self.rx.freq)

    def handle_key(self, key) -> bool:
        """Returns False to quit. `key` is a string key name or a
        ("MOUSE", event, col, row) tuple from the terminal reader."""
        rx, pan = self.rx, self.pan
        if isinstance(key, tuple) and key and key[0] == "MOUSE":
            self.handle_mouse(*key[1:])
            return True
        # text-entry mode (QSO add/search) captures everything until Enter
        if self.text_entry is not None:
            purpose, buf = self.text_entry
            if key in ("\r", "\n", "ENTER"):
                self._commit_text_entry()
            elif key in ("ESC", "\x1b"):
                self.text_entry = None
            elif key in ("BACKSPACE", "\x7f"):
                self.text_entry = (purpose, buf[:-1])
            elif len(key) == 1 and key.isprintable() and len(buf) < 16:
                self.text_entry = (purpose, buf + key)
            return True
        # frequency-entry mode captures everything until Enter/ESC
        if self.freq_entry is not None:
            if key in ("\r", "\n", "ENTER"):
                try:
                    f = float(self.freq_entry)
                    if rx.radio_mode == "CW":
                        from supersdr_tpu_torch.ops.passband import CW_PITCH_HZ
                        f -= CW_PITCH_HZ / 1000.0  # supersdr.py:664
                    self._tune(f)
                    self.message = f"tuned {rx.freq:.1f} kHz"
                except ValueError:
                    self.message = "bad frequency"
                self.freq_entry = None
            elif key in ("ESC", "\x1b"):
                self.freq_entry = None
            elif key == "BACKSPACE" or key == "\x7f":
                self.freq_entry = self.freq_entry[:-1]
            elif (key.isdigit() or key == ".") and len(self.freq_entry) < 10:
                self.freq_entry += key
            return True
        if key == "q":
            return False
        elif key == "f":
            self.freq_entry = ""
            self.message = "enter frequency (kHz):"
        elif key in ("LEFT", "RIGHT"):
            self._tune(rx.freq + (1.0 if key == "RIGHT" else -1.0))
        elif key in ("<", ">"):
            self._tune(rx.freq + (10.0 if key == ">" else -10.0))
        elif key in ("UP", "DOWN"):
            d = 1 if key == "UP" else -1
            if self.links is not None:
                self.links.zoom(d)
            else:
                pan.set_freq_zoom(rx.freq, pan.zoom + d)
        elif key in ("u", "l", "c", "a"):
            mode = {"u": "USB", "l": "LSB", "c": "CW", "a": "AM"}[key]
            if self.links is not None:
                self.links.set_mode(mode)
            else:
                rx.set_mode(mode)
            self.message = f"mode {rx.radio_mode}"
        elif key == "x":
            self.auto_mode = not self.auto_mode
            self.message = f"auto-mode {'on' if self.auto_mode else 'off'}"
        elif key == "j":
            rx.adjust_passband("low")
        elif key == "k":
            rx.adjust_passband("high")
        elif key == "o":
            rx.reset_passband()
            self.message = "passband reset"
        elif key == "g":
            self.averaging_n = min(100, self.averaging_n + 1)
        elif key == "h":
            self.averaging_n = max(1, self.averaging_n - 1)
        elif key == "v":
            rx.volume = min(300, rx.volume + 10)
        elif key == "b":
            rx.volume = max(0, rx.volume - 10)
        elif key == "m":
            rx.muted = not rx.muted
        elif key == "w":
            self.memories.write_mem(rx.freq, rx.radio_mode, rx.delta_low,
                                    rx.delta_high)
            self.message = f"stored {rx.freq:.1f} kHz"
        elif key == "W":   # SHIFT+W: save all memories to disk
            self.memories.save_to_disk()
            self.message = f"saved {len(self.memories)} memories"
        elif key == "R":   # SHIFT+R: delete all stored memories
            self.memories.reset_all_mem()
            self.message = "memories cleared"
        elif key == "E":   # start/stop audio recording
            self.recording = not self.recording
            self.message = ("recording" if self.recording
                            else "recording stopped")
        elif key in ("PGUP", "PGDN"):   # span +/- SPAN/4
            pan.page(1 if key == "PGUP" else -1)
        elif key == ",":
            self.wf_delta_high_db -= 1.0
        elif key == ".":
            self.wf_delta_high_db += 1.0
        elif key == ";":   # SHIFT variants of ,/. on the low clip
            self.wf_delta_low_db -= 1.0
        elif key == "'":
            self.wf_delta_low_db += 1.0
        elif key == "s" and self.links is not None:
            fl = self.links.flags
            fl.cat_snd_link = not fl.cat_snd_link
            self.message = f"CAT sync {'on' if fl.cat_snd_link else 'off'}"
        elif key == "r":
            mem = self.memories.recall_mem()
            if mem:
                freq, mode, dl, dh = mem
                rx.radio_mode = mode
                rx.change_passband(dl, dh)
                was_auto, self.auto_mode = self.auto_mode, False
                self._tune(freq)
                self.auto_mode = was_auto
                self.message = f"recall {freq:.1f} kHz {mode}"
        elif key == " ":
            pan.set_freq_zoom(rx.freq, pan.zoom)
        elif key == "i":
            self.show_eibi = not self.show_eibi
            if self.show_eibi and self.eibi is None:
                from supersdr_tpu_torch.control.eibi import EibiDb
                self.eibi = EibiDb()
            self.message = f"EIBI {'on' if self.show_eibi else 'off'}"
        elif key == "d":
            self.show_dx = not self.show_dx
            self.message = f"DX cluster {'on' if self.show_dx else 'off'}"
        elif key == "1":   # AGC threshold down (supersdr key 1)
            rx.set_agc_params(thresh=max(-130, rx.agc.thresh - 5))
            self.message = f"AGC thresh {rx.agc.thresh} dB"
        elif key == "2":   # AGC threshold up
            rx.set_agc_params(thresh=min(0, rx.agc.thresh + 5))
            self.message = f"AGC thresh {rx.agc.thresh} dB"
        elif key == "!":   # SHIFT+1: AGC decay down
            rx.agc.change_delay(-200, rx.radio_mode)
            rx.refresh_params()
            self.message = f"AGC decay {rx.agc.decay} ms"
        elif key == "@":   # SHIFT+2: AGC decay up
            rx.agc.change_delay(+200, rx.radio_mode)
            rx.refresh_params()
            self.message = f"AGC decay {rx.agc.decay} ms"
        elif key == "3":   # WF autoscale: reset the clip deltas
            self.wf_delta_low_db = 0.0
            self.wf_delta_high_db = 0.0
            self.message = "WF autoscale"
        elif key == "4":   # spectrum filling on/off
            self.spectrum_fill = not self.spectrum_fill
        elif key == "0":   # add QSO to log
            self.text_entry = ("qso_add", "")
            self.message = "log QSO — callsign:"
        elif key == "9":   # search QSO
            self.text_entry = ("qso_search", "")
            self.message = "search QSO — callsign:"
        elif key == "?":
            self.show_help = not self.show_help
        return True

    def _col_to_khz(self, col: int) -> float:
        pan = self.pan
        f = pan.start_f_khz + (col + 0.5) / self.width * pan.span_khz
        return round(f * 10.0) / 10.0           # 100 Hz step grid

    def _mouse_region(self, row: int) -> str:
        """'spectrum' / 'wf' / 'outside' from the last render's geometry
        (reference zones: waterfall area tunes, spectrum row drags the
        span — supersdr.py:703-713). Before any render, every row counts
        as the waterfall so scripted/mouse-only callers keep working."""
        if self._spectrum_row is None:
            return "wf"
        row = row - self._row_shift
        if row == self._spectrum_row:
            return "spectrum"
        if self._wf_row0 is not None and row >= self._wf_row0:
            return "wf"
        return "outside"

    def _click_tune(self, col: int) -> None:
        f = self._col_to_khz(col)
        if self.rx.radio_mode == "CW":
            from supersdr_tpu_torch.ops.passband import CW_PITCH_HZ
            f -= CW_PITCH_HZ / 1000.0
        self._tune(f)
        self.message = f"tuned {self.rx.freq:.1f} kHz"

    def handle_mouse(self, event: str, col: int, row: int = 0,
                     shift: bool = False) -> None:
        """Mouse gestures (reference supersdr.py:688-719, 836-873):

          press in the waterfall      → tune (CW: BFO-corrected); keeps a
                                        drag → continuous drag-tuning
          SHIFT+press in the waterfall→ drag the nearest passband edge
                                        (100 Hz per column, CW ÷5 —
                                        supersdr.py:307-373 step rules)
          press on the spectrum row   → drag pans the span (the reference
                                        spectrum-bar drag, :710-719)
          wheel                       → zoom
        Clicks outside the rendered spectrum/waterfall area are ignored.
        """
        pan = self.pan
        if event in ("wheel_up", "wheel_down"):
            if self._mouse_region(row) == "outside" or col >= self.width:
                return
            d = 1 if event == "wheel_up" else -1
            if self.links is not None:
                self.links.zoom(d)
            else:
                pan.set_freq_zoom(self.rx.freq, pan.zoom + d)
            return
        if event == "release":
            self.drag = None
            return
        if event in ("press", "click"):
            region = self._mouse_region(row)
            if region == "outside" or not (0 <= col < self.width):
                self.drag = None
                return
            if region == "spectrum":
                self.drag = ("pan", col)
            elif shift:
                # passband-edge drag: pick the edge by which side of the
                # carrier the grab lands on
                f = self._col_to_khz(col)
                carrier = self.rx.freq
                which = "high" if f >= carrier + (self.rx.lc + self.rx.hc) \
                    / 2000.0 else "low"
                self.drag = ("pb", col, which)
                self.message = f"drag passband {which}"
            else:
                self.drag = ("tune", col)
                self._click_tune(col)
            return
        if event == "drag":
            if self.drag is None:
                return
            kind, last = self.drag[0], self.drag[1]
            dcol = col - last
            if dcol == 0:
                return
            if kind == "tune":
                self._click_tune(col)
                self.drag = ("tune", col)
            elif kind == "pan":
                # drag the spectrum: span moves opposite the pointer
                # (manual_wf_freq = wf.freq - delta, supersdr.py:715-719)
                delta_khz = dcol / self.width * pan.span_khz
                pan.set_freq_zoom(pan.freq_khz - delta_khz, pan.zoom)
                self.drag = ("pan", col)
            elif kind == "pb":
                which = self.drag[2]
                for _ in range(min(abs(dcol), 8)):
                    if which == "high":
                        # dragging right widens the high edge (+step)
                        self.rx.adjust_passband("high", shift=dcol < 0)
                    else:
                        # dragging left widens the low edge (-step)
                        self.rx.adjust_passband("low", shift=dcol > 0)
                self.message = (f"passband [{int(self.rx.lc):+d},"
                                f"{int(self.rx.hc):+d}] Hz")
                self.drag = ("pb", col, which)

    # ---------------------------------------------------------- rendering

    def status_line(self) -> str:
        rx = self.rx
        if self.freq_entry is not None:
            entry = f"  F> {self.freq_entry}_"
        elif self.text_entry is not None:
            entry = f"  {self.text_entry[0]}> {self.text_entry[1]}_"
        else:
            entry = " REC" if self.recording else ""
        return (f" {rx.freq:9.2f} kHz  {rx.radio_mode:<4} "
                f"[{int(rx.lc):+5d},{int(rx.hc):+5d}]Hz  "
                f"vol {rx.volume:3d}%{' MUTE' if rx.muted else ''}  "
                f"avg {self.averaging_n:<3d} "
                f"{smeter_text(rx.smoothed_rssi)}{entry}")

    def span_line(self) -> str:
        pan = self.pan
        return (f" span {pan.start_f_khz:9.1f} — {pan.end_f_khz:9.1f} kHz  "
                f"zoom {pan.zoom:2d}  ({pan.span_khz:.1f} kHz)"
                f"   {self.message}")

    def _col(self, f_khz: float) -> int:
        pan = self.pan
        return int((f_khz - pan.start_f_khz) / pan.span_khz * self.width)

    def overlay_lines(self) -> list[str]:
        """Station/spot/beacon markers across the span + a short legend
        (reference plot_eibi/plot_dxcluster/plot_beacons semantics:
        utils:1693-1730,1755-1786,1787-1804)."""
        pan = self.pan
        marks = [" "] * self.width
        legend: list[str] = []
        if self.show_eibi and self.eibi is not None:
            freqs = self.eibi.get_stations(pan.start_f_khz, pan.end_f_khz)
            center = pan.freq_khz
            for f in sorted(freqs, key=lambda f: abs(f - center)):
                c = self._col(f)
                if 0 <= c < self.width:
                    marks[c] = "▼"
                    if len(legend) < 3:
                        names = self.eibi.get_names(f)
                        if names:
                            legend.append(f"{f:.0f} {names[0][:18]}")
            from supersdr_tpu_torch.control import beacons as bcn
            for band, call in bcn.which_beacons().items():
                f = bcn.FREQ_KHZ[band]
                c = self._col(f)
                if 0 <= c < self.width:
                    marks[c] = "◆"
                    if len(legend) < 4:
                        legend.append(f"{f} bcn {call}")
        if self.show_dx and self.dx is not None:
            # DxCluster.get_stations gives spot ids; the mark goes at the
            # spot's frequency
            for sid in self.dx.get_stations(pan.start_f_khz, pan.end_f_khz):
                c = self._col(self.dx.spot(sid)[1])
                if 0 <= c < self.width:
                    marks[c] = "x"
        out = ["".join(marks)]
        if legend:
            out.append(" " + " | ".join(legend))
        return out

    def render(self) -> list[str]:
        lines = [self.status_line(), self.span_line()]
        if self.show_help:
            return lines + HELP_LINES
        if self.show_eibi or self.show_dx:
            lines.extend(self.overlay_lines())
        if self.history:
            self._spectrum_row = len(lines)
            self._wf_row0 = len(lines) + 1
            lines.append(spectrum_row_text(
                np.mean(self.history[:min(15, len(self.history))], axis=0),
                self.width, fill=self.spectrum_fill))
            for row in self.history:
                lines.append(waterfall_row_ansi(row, self.width))
        return lines


def run_tui_wav(path: str, mode: str = "AM", freq_khz: float = 14200.0,
                fps: float = 0.0, width: int = 0, height: int = 0,
                speed: float = 4.0, device=None):
    """Offline TUI: play a KiwiSDR IQ WAV through the chain, render with
    plain ANSI (no curses dependency), keys via stdin when a TTY.

    fps caps the refresh rate (0 = pace purely by `speed`× realtime);
    width/height override the terminal-derived display size (reference
    -r/-W/-H flags, supersdr.py:26-35). The receiver and the waterfall's
    FFT run on `device` (None: the current CUDA device); each chunk's
    waterfall colors come back to the host for the terminal."""
    import sys
    import time

    from supersdr_tpu_torch.io import wav
    from supersdr_tpu_torch.ops import spectrum
    from supersdr_tpu_torch.runtime import chain

    t, z = wav.read_kiwi_iq_wav(path)
    fs = int(round(1.0 / np.median(np.diff(t[:10000]))))
    fs = min((12000, 20250, 24000, 48000), key=lambda r: abs(r - fs))
    cfg = chain.ChainConfig(mode=mode, iq_rate=fs, audio_rate=4 * fs,
                            chunk=2048, os_block=2048)
    rx = Receiver(cfg=cfg, center_freq_khz=freq_khz, freq=freq_khz,
                  radio_mode=mode, device=device)
    pan = Panadapter(zoom=10, freq_khz=freq_khz)
    term = shutil.get_terminal_size((100, 30))
    width = width or min(term.columns - 2, 160)
    wf_height = height or max(4, term.lines - 6)
    model = TuiModel(rx=rx, pan=pan, width=width, wf_height=wf_height)
    win = spectrum.spectrum_window(1024, device=rx.device)
    min_frame_s = 1.0 / fps if fps > 0 else 0.0
    last_draw = 0.0
    for i in range(0, len(z) - 2048, 2048):
        rx.process(z[i:i + 2048])
        db = spectrum.waterfall_rows_db(z[i:i + 2048].astype(np.complex64),
                                        win, 1024)
        res = spectrum.autolevel(db)
        for row in res.color.cpu().numpy():
            model.push_row(row)
        now = time.monotonic()
        if now - last_draw >= min_frame_s:
            last_draw = now
            sys.stdout.write("\x1b[2J\x1b[H" + "\n".join(model.render())
                             + "\n")
            sys.stdout.flush()
        time.sleep(2048 / fs / max(speed, 1e-6))
    # always render the end state (an fps cap may have skipped it)
    sys.stdout.write("\x1b[2J\x1b[H" + "\n".join(model.render()) + "\n")
    sys.stdout.flush()
    return model
