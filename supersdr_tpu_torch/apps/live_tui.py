"""Live interactive panadapter session: the reference's core UX, headless.

The reference's main loop runs a realtime waterfall + keyboard tuning +
CAT sync together (supersdr.py:179-1073). This module
wires the same pieces natively: an IQ source (live KiwiSDR stream or any
chunk iterator) feeds the port's receiver chain(s) and a native FFT
waterfall on the MAIN receiver's device, while keys drive the
LinkController (tune/mode/zoom/CAT) and the dual-RX surface
(supersdr.py:575-639):

  y        enable SUB RX (on the span center) / switch MAIN↔SUB
  Y        disable SUB RX (transferring parameters if MAIN is the sub)
  n        tune SUB RX to the span center
  5 / 6    audio balance of the active (MAIN) receiver left/right

Everything is injectable — IQ source, key source, audio sink, clock — so
tests drive a full interactive session deterministically (SURVEY.md §4).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np

from supersdr_tpu_torch.apps.tui import TuiModel
from supersdr_tpu_torch.control.links import LinkController
from supersdr_tpu_torch.control.panadapter import Panadapter
from supersdr_tpu_torch.control.receiver import Flags, Receiver
from supersdr_tpu_torch.ops import spectrum


@dataclass
class LiveTui:
    """Interactive session over an IQ chunk source."""
    rx: Receiver
    pan: Panadapter
    model: TuiModel
    links: LinkController
    nfft: int = 1024
    rx_sub: Receiver | None = None
    main_is_sub: bool = False   # reference main_sub_switch_flag
    native_waterfall: bool = True  # False: rows pushed externally (live
                                   # W/F stream at the panadapter span)
    # interactive server switching (reference server book + connect_new
    # flow, supersdr.py:743-796 / utils_supersdr.py:394-547): `K` opens
    # the book, a digit connects, failure reverts to the live server
    server_book: object = None         # control.kiwilist.KiwiList
    switch_server: object = None       # callable(entry) -> (ok, message)
    server_menu: bool = False
    _win: np.ndarray = field(default=None, repr=False)
    _recorder: object = field(default=None, repr=False)
    _dual: object = field(default=None, repr=False)   # runtime.dualrx
    _dual_key: tuple = field(default=None, repr=False)

    @classmethod
    def create(cls, rx: Receiver, pan: Panadapter, width: int = 100,
               wf_height: int = 18, cat=None, flags: Flags | None = None,
               nfft: int = 1024) -> "LiveTui":
        links = LinkController(wf=pan, rx=rx, flags=flags or Flags())
        links.cat = cat
        model = TuiModel(rx=rx, pan=pan, width=width, wf_height=wf_height,
                         links=links)
        return cls(rx=rx, pan=pan, model=model, links=links, nfft=nfft)

    def __post_init__(self):
        self._win = spectrum.spectrum_window(self.nfft,
                                             device=self.rx.device)

    # ------------------------------------------------------------ dual RX

    def _clone_rx(self, freq_khz: float) -> Receiver:
        r = Receiver(cfg=self.rx.cfg, center_freq_khz=self.rx.center_freq_khz,
                     freq=freq_khz, radio_mode=self.rx.radio_mode,
                     device=self.rx.device)
        return r

    def enable_or_switch_sub(self) -> None:
        """`y`: create the SUB RX on the span center, or swap MAIN↔SUB
        (supersdr.py:610-633)."""
        if self.rx_sub is None:
            self.rx_sub = self._clone_rx(self.pan.freq_khz)
            self.model.message = "SUB RX enabled"
        else:
            self.rx, self.rx_sub = self.rx_sub, self.rx
            self.main_is_sub = not self.main_is_sub
            self.model.rx = self.rx
            self.links.rx = self.rx
            self.links._push_cat()
            self.model.message = "switch MAIN/SUB RXs"

    def disable_sub(self) -> None:
        """`Y`: drop the SUB RX; if the current MAIN is the sub session,
        transfer its tuning back first (supersdr.py:587-609)."""
        if self.rx_sub is None:
            return
        if self.main_is_sub:
            self.rx_sub.radio_mode = self.rx.radio_mode
            self.rx_sub.tune(self.rx.freq)
            self.rx, self.rx_sub = self.rx_sub, self.rx
            self.main_is_sub = False
            self.model.rx = self.rx
            self.links.rx = self.rx
        self.rx_sub = None
        self.model.message = "SUB RX disabled"

    def sub_to_center(self) -> None:
        """`n`: tune the SUB RX to the span center (supersdr.py:580-584)."""
        if self.rx_sub is not None:
            self.rx_sub.tune(self.pan.freq_khz)

    # ------------------------------------------------------ server switch

    def open_server_menu(self) -> None:
        """`K`: open the server book (reference chooser dialog,
        utils_supersdr.py:455-547). Digits connect; ESC/K closes."""
        if self.server_book is None or self.switch_server is None:
            self.model.message = "no server book"
            return
        self.server_menu = not self.server_menu

    def _menu_key(self, key) -> bool:
        if key in ("ESC", "\x1b", "K", "q"):
            self.server_menu = False
            return True
        if isinstance(key, str) and key.isdigit():
            idx = int(key) - 1
            servers = list(self.server_book)
            if 0 <= idx < len(servers):
                self.server_menu = False
                entry = servers[idx]
                ok, msg = self.switch_server(entry)
                self.model.message = msg
            return True
        return True  # menu swallows everything else

    # --------------------------------------------------------------- keys

    def handle_key(self, key: str) -> bool:
        if self.server_menu:
            return self._menu_key(key)
        if self.model.freq_entry is not None or self.model.text_entry is not None:
            return self.model.handle_key(key)  # entry modes capture all keys
        if key == "K":
            self.open_server_menu()
            return True
        if key == "y":
            self.enable_or_switch_sub()
            return True
        if key == "Y":
            self.disable_sub()
            return True
        if key == "n":
            self.sub_to_center()
            return True
        if key == "5":
            self.rx.audio_balance = max(-1.0, self.rx.audio_balance - 0.5)
            return True
        if key == "6":
            self.rx.audio_balance = min(1.0, self.rx.audio_balance + 0.5)
            return True
        return self.model.handle_key(key)

    # --------------------------------------------------------------- audio

    def _dual_process(self, iq_chunk: np.ndarray) -> np.ndarray:
        """MAIN+SUB through ONE chain call (runtime/dualrx.py): a fixed
        [2, chunk] slot axis whose per-slot tuning/mode/AGC are runtime
        data written into the same device tensors — SUB add/drop and every
        retune keep one set of device buffers (SURVEY §2a: channels are an
        array axis, not threads)."""
        from supersdr_tpu_torch.runtime.dualrx import DualChain
        sub = self.rx_sub if self.rx_sub is not None else self.rx
        # rebuild on ANY structural cfg change — a server switch can land
        # on a different iq_rate/chunk (e.g. a 20.25 kHz kiwi), and a
        # stale DualChain would reshape-fail or resample at the old ratio
        def _structure(cfg):
            return (cfg.iq_rate, cfg.chunk, cfg.os_block, cfg.audio_rate,
                    cfg.blanker_enabled)
        if self._dual is None or _structure(self._dual.cfg) \
                != _structure(self.rx.cfg):
            self._dual = DualChain(self.rx.cfg, device=self.rx.device)
            self._dual_key = None
        key = (id(self.rx), self.rx.rev, id(sub), sub.rev,
               self.rx_sub is not None)
        if key != self._dual_key:
            self._dual.refresh([self.rx, sub],
                               [True, self.rx_sub is not None])
            self._dual_key = key
        audio2, rssi2 = self._dual.process(iq_chunk)
        main_audio = self.rx.post_audio(audio2[0], rssi2[0, -1])
        out = self.rx.stereo(main_audio)
        if self.rx_sub is not None:
            sub_audio = sub.post_audio(audio2[1], rssi2[1, -1])
            out = out + sub.stereo(sub_audio)
            out = np.clip(out, -1.0, 1.0)
        return out

    def step(self, iq_chunk: np.ndarray) -> np.ndarray:
        """One chunk through MAIN (+SUB) → stereo float32 [n, 2]; native
        waterfall rows pushed to the model; recording honored ('E')."""
        out = self._dual_process(iq_chunk)
        if self.model.recording:
            if self._recorder is None:
                from supersdr_tpu_torch.io.wav import AudioRecorder
                self._recorder = AudioRecorder(self.rx.cfg.audio_rate)
                self.model.message = f"rec → {self._recorder.start()}"
            self._recorder.append(out)
        elif self._recorder is not None:
            self.model.message = f"saved {self._recorder.stop()}"
            self._recorder = None
        if self.native_waterfall and len(iq_chunk) >= self.nfft:
            db = spectrum.waterfall_rows_db(
                np.asarray(iq_chunk, np.complex64), self._win, self.nfft)
            db = spectrum.time_binned_average(
                db, max(1, min(self.model.averaging_n, db.shape[0])))
            res = spectrum.autolevel(
                db, delta_low_db=self.model.wf_delta_low_db,
                delta_high_db=self.model.wf_delta_high_db)
            for row in res.color.cpu().numpy():
                self.model.push_row(row)
        return out

    # ----------------------------------------------------------------- run

    def run(self, source: Iterator[np.ndarray],
            keys: Callable[[], list[str]] | None = None,
            sink: Callable[[np.ndarray], None] | None = None,
            render: Callable[[list[str]], None] | None = None,
            fps: float = 15.0, poll_cat_every: int = 4,
            on_tick: Callable[[], None] | None = None,
            clock: Callable[[], float] = time.monotonic) -> None:
        """Pump the session: IQ chunks in, stereo audio out, ANSI frames
        rendered at ≤fps, keys applied between chunks, CAT polled
        periodically (reference render tick, supersdr.py:883-947).
        `on_tick` runs after each chunk+keys (e.g. W/F zoom sync)."""
        min_frame_s = 1.0 / fps if fps > 0 else 0.0
        last_draw = -1e9
        for i, chunk in enumerate(source):
            for k in (keys() if keys else []):
                if not self.handle_key(k):
                    return
            audio = self.step(chunk)
            if sink is not None:
                sink(audio)
            if poll_cat_every and i % poll_cat_every == 0:
                self.links.poll_cat()
            if on_tick is not None:
                on_tick()
            now = clock()
            if render is not None and now - last_draw >= min_frame_s:
                last_draw = now
                render(self.render_lines())

    def render_lines(self) -> list[str]:
        if self.server_menu:
            lines = [" KiwiSDR server book — digit connects, ESC cancels"]
            for i, (host, port, pw, comment) in enumerate(self.server_book):
                note = f"  # {comment}" if comment else ""
                lines.append(f"  {i + 1}. {host}:{port}{note}")
            if len(lines) == 1:
                lines.append("  (empty kiwi.list)")
            return lines
        lines = self.model.render()
        self.model._row_shift = 0
        if self.rx_sub is not None:
            self.model._row_shift = 1
            lines.insert(1, f" SUB {self.rx_sub.freq:9.2f} kHz "
                            f"{self.rx_sub.radio_mode:<4} "
                            f"bal {self.rx_sub.audio_balance:+.1f}"
                            f"{'  [MAIN=sub session]' if self.main_is_sub else ''}")
        return lines


def wf_row_to_color(bins_u8: np.ndarray, zoom: int,
                    delta_low_db: float = 0.0,
                    delta_high_db: float = 0.0) -> np.ndarray:
    """Server W/F row (uint8) → 0..255 color row, host-side numpy: the
    reference dB calibration -(255-b)-13+3·zoom (utils:787-790) and the
    P40/P100 percentile auto-level with ≥40 dB displayed range
    (utils:793-813). Kept off-device: one 1024-byte row per frame does
    not merit a device dispatch."""
    wf = bins_u8.astype(np.float32)
    db = -(255.0 - wf) - 13.0 + 3.0 * zoom
    db[0] = db[1]                       # broken first bin, as upstream
    low = np.percentile(db, spectrum.CLIP_LOW_PERCENTILE)
    high = np.percentile(db, spectrum.CLIP_HIGH_PERCENTILE)
    dyn = max(high - low, spectrum.MIN_DYN_RANGE_DB)
    shifted = db - (low + delta_low_db)
    norm = (dyn + delta_high_db) - delta_low_db
    return np.clip(np.clip(shifted / norm, 0.0, 1.0) * 254.0, 0.0, 255.0)


def ansi_render(lines: list[str]) -> None:
    sys.stdout.write("\x1b[2J\x1b[H" + "\n".join(lines) + "\n")
    sys.stdout.flush()


def parse_escape(seq: str):
    """CSI sequence (after ESC) → key name or MOUSE tuple, or None for
    unrecognized sequences (a stray SS3/function-key report must NOT read
    as ESC — that would silently cancel freq/text entry).

    SGR-1006 mouse reports `[<b;x;yM|m`: button 0 left, +4 SHIFT
    modifier, +32 motion-while-pressed (needs ?1002 tracking), 64/65
    wheel. Events map to the reference's gestures (supersdr.py:688-719,
    836-873): press = click-to-tune / drag start, drag = continuous
    tune / span pan / passband-edge drag, release ends the drag.
    Returns ("MOUSE", kind, col, row, shift)."""
    named = {"[A": "UP", "[B": "DOWN", "[C": "RIGHT", "[D": "LEFT",
             "[5~": "PGUP", "[6~": "PGDN"}
    if seq in named:
        return named[seq]
    if seq.startswith("[<") and seq[-1] in "Mm":
        try:
            b, x, y = (int(v) for v in seq[2:-1].split(";"))
        except ValueError:
            return None
        shift = bool(b & 4)
        if b & 64:
            if seq[-1] == "m":
                return None
            kind = "wheel_up" if (b & 1) == 0 else "wheel_down"
            return ("MOUSE", kind, x - 1, y - 1, shift)
        if (b & 3) != 0:            # middle/right buttons — unused
            return None
        if seq[-1] == "m":
            return ("MOUSE", "release", x - 1, y - 1, shift)
        if b & 32:
            return ("MOUSE", "drag", x - 1, y - 1, shift)
        return ("MOUSE", "press", x - 1, y - 1, shift)
    return None


def stdin_keys(mouse: bool = True) -> Callable[[], list]:
    """Non-blocking raw-mode key reader for a TTY (arrow keys + SGR
    mouse reporting incl. ?1002 button-motion tracking for drag
    gestures; `.restore()` resets the terminal)."""
    import select
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    if mouse:
        sys.stdout.write("\x1b[?1000h\x1b[?1002h\x1b[?1006h")
        sys.stdout.flush()

    def _ready():
        return select.select([sys.stdin], [], [], 0)[0]

    def poll() -> list:
        out = []
        while _ready():
            ch = sys.stdin.read(1)
            if ch != "\x1b":
                out.append(ch)
                continue
            seq = ""
            while _ready() and len(seq) < 24:
                c = sys.stdin.read(1)
                seq += c
                if len(seq) >= 2 and c.isalpha() or c == "~":
                    break
            key = parse_escape(seq) if seq else "ESC"
            if key is not None:
                out.append(key)
        return out

    def restore():
        if mouse:
            sys.stdout.write("\x1b[?1006l\x1b[?1002l\x1b[?1000l")
            sys.stdout.flush()
        termios.tcsetattr(fd, termios.TCSADRAIN, old)

    poll.restore = restore
    return poll
