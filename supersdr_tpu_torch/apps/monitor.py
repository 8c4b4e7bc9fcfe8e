"""Wideband monitor: the N-receiver channelized band view (SURVEY §7's
"wideband-monitor/channelizer app").

Generalizes the reference's two-receiver ceiling (one MAIN + one SUB
socket pair, supersdr.py:624-639) to the whole band:
ONE wideband capture → polyphase channelizer → every channel
demodulated at once (BASELINE config 5), presented as

  * a per-channel RSSI table (EWMA-smoothed, row-aligned through the
    process fn's `channel_order` — planar rows on the fused tiers),
  * a squelch-gated ACTIVITY list (open/close hysteresis per channel,
    mirroring ops/squelch semantics at the monitor cadence), and
  * select-channel-to-audio: any active channel's demodulated audio can
    be recorded to WAV (or handed to a sink) while the rest of the band
    keeps scanning.

`MonitorCore` is headless and pump-testable (driven live against
io/fake_kiwi wideband IQ); `run_monitor` wraps it in the ANSI TUI loop for
`python -m supersdr_tpu_torch.cli monitor`.

The pipeline runs on `device` (None: the params' device when params are
given, else the current CUDA device). Each chunk's audio and RSSI stay on
the device: only the RSSI row means (n_chan floats) come to the host every
chunk, and the selected row when it is recorded or asked for (at 2560
channels × 16128 frames the whole audio is 660 MB a chunk). On a CUDA
device whose configuration runs the planar tier, the default process
function replays each wire chunk (an int16 pair) as a CUDA graph held for
the stream (`runtime/stream_graph.py`), recorded here, before the first
chunk; other chunks, tiers and devices, and a process function the caller
gives, run eagerly.

Under a running `torch.profiler` (`utils/profiling.span`), `push` records
the span `monitor.push`, a root with a chunk identifier of its own, and
inside it `monitor.process` (the process function's call) and
`monitor.rssi_fetch` (the RSSI means to the host); `selected_audio`
records `monitor.selected_audio` under the last pushed chunk's identifier,
with `monitor.audio_fetch` (the row to the host) inside. Each fetch of a
device tensor counts as a host sync (`profiling.count_sync`).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from supersdr_tpu_torch.device import default_device
from supersdr_tpu_torch.io import wav as wav_io
from supersdr_tpu_torch.runtime import stream_graph, wideband
from supersdr_tpu_torch.utils import profiling


@dataclass
class MonitorCore:
    """Headless monitor state machine over a channelized process fn."""

    cfg: wideband.WidebandConfig
    params: object = None
    process_fn: object = None        # (params, state, iq) -> (st, audio, rssi)
    channel_order: np.ndarray = None  # row -> PFB bin for the process fn
    thresh_db: float = -90.0          # activity gate (RSSI dB)
    hyst_db: float = 6.0              # close at thresh - hyst
    ewma: float = 0.6                 # RSSI smoothing (new-sample weight)
    selected: int = 0                 # selected ROW index
    chunks: int = 0
    rssi_rows: np.ndarray = field(default=None, repr=False)
    open_rows: np.ndarray = field(default=None, repr=False)
    recorder: object = field(default=None, repr=False)
    device: torch.device | str | None = None
    _last_audio: torch.Tensor = field(default=None, repr=False)
    _chunk_id: int | None = field(default=None, repr=False)

    def __post_init__(self):
        cfg = self.cfg
        if self.device is None and self.params is not None:
            self.device = self.params.W_pfb.device
        self.device = default_device(self.device)
        if self.params is None:
            self.params = wideband.make_params(cfg, device=self.device)
        self.state = wideband.init_state(cfg, device=self.device)
        if self.process_fn is None:
            def _serial(params, state, iq):
                if isinstance(iq, tuple):        # (re_i16, im_i16) wire
                    st, out = wideband.process_i16(cfg, params, state, iq)
                else:
                    st, out = wideband.process(cfg, params, state, iq)
                return st, out.audio, out.rssi
            self.process_fn = stream_graph.wrap(cfg, self.params, self.state,
                                                _serial)
            self.channel_order = wideband.audio_channel_order(cfg)
        elif self.channel_order is None:
            self.channel_order = getattr(self.process_fn, "channel_order",
                                         np.arange(cfg.n_chan))
        # row-aligned absolute channel frequencies (ADVICE r4 API)
        self.freqs = wideband.channel_freqs(cfg, order=self.channel_order)
        self.rssi_rows = np.full(cfg.n_chan, -120.0, np.float32)
        self.open_rows = np.zeros(cfg.n_chan, bool)

    # -------- streaming

    def push(self, iq_chunk) -> None:
        """One wideband chunk through the pipeline; updates the RSSI
        table, the activity gates, and the selected-channel recording."""
        with profiling.span("monitor.push"):
            self._chunk_id = profiling.current_chunk()
            with profiling.span("monitor.process"):
                self.state, audio, rssi = self.process_fn(
                    self.params, self.state, iq_chunk)
            if self.cfg.time_major:
                audio = audio.T                 # -> [rows, time], a view
            r = rssi.float()
            r = r.mean(dim=-1) if r.ndim > 1 else r
            with profiling.span("monitor.rssi_fetch"):
                r = self._host(r)
            self.rssi_rows = ((1.0 - self.ewma) * self.rssi_rows
                              + self.ewma * r).astype(np.float32)
            opens = self.rssi_rows >= self.thresh_db
            closes = self.rssi_rows < self.thresh_db - self.hyst_db
            self.open_rows = (self.open_rows | opens) & ~closes
            self.chunks += 1
            self._last_audio = audio
            if self.recorder is not None:
                self.recorder.append(np.clip(self.selected_audio(), -1, 1))

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        """A device tensor's values on the host, as float32 numpy (the
        only crossings of `push`); a fetch from a card counts as a host
        sync."""
        if t.device.type != "cpu":
            profiling.count_sync()
        return t.float().cpu().numpy()

    # -------- queries

    def activity(self, top: int | None = None):
        """Squelch-gated activity list: [(row, freq_hz, rssi_db)] of
        OPEN channels, strongest first."""
        rows = np.flatnonzero(self.open_rows)
        rows = rows[np.argsort(self.rssi_rows[rows])[::-1]]
        if top is not None:
            rows = rows[:top]
        return [(int(i), float(self.freqs[i]), float(self.rssi_rows[i]))
                for i in rows]

    def selected_audio(self) -> np.ndarray | None:
        """Selected channel's audio from the last chunk."""
        with profiling.span("monitor.selected_audio", self._chunk_id):
            if self._last_audio is None:
                return None
            row = self._last_audio[self.selected]
            with profiling.span("monitor.audio_fetch"):
                return self._host(row)

    # -------- control

    def select_row(self, row: int) -> None:
        self.selected = int(row) % self.cfg.n_chan

    def select_freq(self, freq_hz: float) -> int:
        """Select the channel row whose center is nearest `freq_hz`."""
        self.selected = int(np.argmin(np.abs(self.freqs - freq_hz)))
        return self.selected

    def start_recording(self, path: str) -> str:
        self.recorder = wav_io.AudioRecorder(self.cfg.audio_rate)
        self.recorder.start(path)
        return path

    def stop_recording(self) -> str | None:
        if self.recorder is None:
            return None
        out = self.recorder.stop()
        self.recorder = None
        return out

    def handle_key(self, key: str) -> bool:
        """TUI keys; returns False on quit."""
        if key in ("q", "\x1b"):
            return False
        if key in ("up", "k"):
            act = [r for r, _, _ in self.activity()] or [self.selected]
            i = act.index(self.selected) if self.selected in act else 0
            self.select_row(act[(i - 1) % len(act)])
        elif key in ("down", "j"):
            act = [r for r, _, _ in self.activity()] or [self.selected]
            i = act.index(self.selected) if self.selected in act else 0
            self.select_row(act[(i + 1) % len(act)])
        elif key == "[":
            self.thresh_db -= 3.0
        elif key == "]":
            self.thresh_db += 3.0
        elif key == "a":
            if self.recorder is None:
                self.start_recording(
                    f"monitor_{self.freqs[self.selected] / 1e3:+.1f}kHz.wav")
            else:
                self.stop_recording()
        return True

    # -------- rendering (plain ANSI, like apps/tui.py)

    def render_lines(self, width: int = 78, max_rows: int = 20
                     ) -> list[str]:
        cfg = self.cfg
        act = self.activity()
        lines = [
            f"WIDEBAND MONITOR  {cfg.n_chan} ch × "
            f"{cfg.iq_rate / 1e3:.1f} kHz  mode={cfg.mode}  "
            f"chunk #{self.chunks}  squelch {self.thresh_db:+.0f} dB  "
            f"active {len(act)}/{cfg.n_chan}"
            + ("  REC" if self.recorder is not None else ""),
            "  row    freq        RSSI  meter",
        ]
        for row, f_hz, rssi in act[:max_rows]:
            n = int(np.clip((rssi + 120.0) / 70.0, 0, 1) * 24)
            mark = ">" if row == self.selected else " "
            lines.append(f"{mark} {row:4d}  {f_hz / 1e3:+9.1f}k  "
                         f"{rssi:+6.1f}  {'█' * n}")
        if not act:
            lines.append("  (no channels above squelch)")
        sel_f = self.freqs[self.selected] / 1e3
        lines.append(f"sel row {self.selected} @ {sel_f:+.1f} kHz   "
                     "keys: j/k select  [/] squelch  a rec  q quit")
        return [ln[:width] for ln in lines]


def _wav_source(z: np.ndarray, cfg: wideband.WidebandConfig):
    """Whole chunks of a capture already read (the reference reads the
    WAV three times; its Python reader is most of a wideband run's
    wall)."""
    z = z.astype(np.complex64)
    n = (len(z) // cfg.chunk_in) * cfg.chunk_in
    for i in range(0, n, cfg.chunk_in):
        yield z[i:i + cfg.chunk_in]


def _kiwi_source(args, cfg: wideband.WidebandConfig):
    """Live IQ frames from a (fake or real) KiwiSDR, accumulated into
    wideband chunks — the server is the dumb digitizer, every channel
    demodulates natively (apps/kiwi_session.py pattern)."""
    from supersdr_tpu_torch.io import kiwi_protocol as kp
    from supersdr_tpu_torch.io.kiwi_client import KiwiClient, KiwiError

    client = KiwiClient(args.kiwiserver, args.kiwiport,
                        getattr(args, "password", ""))
    client.connect()
    client.setup_sound("IQ", -5000, 5000, getattr(args, "freq", 10000.0))
    first = client.wait_for_stream()
    buf = (np.zeros(0, np.int16), np.zeros(0, np.int16))
    pending = [first]
    n_frames = 0
    max_frames = getattr(args, "frames", 0)
    try:
        while not max_frames or n_frames < max_frames:
            frame = pending.pop() if pending else None
            if frame is None:
                try:
                    msg = client.read()
                except KiwiError:
                    break
                if not isinstance(msg, kp.SndFrame):
                    continue
                frame = msg
            kind, _gps, pl_ = client.snd_samples_i16(frame)
            if kind != "iq16":
                continue
            n_frames += 1
            try:
                client.keepalive()
            except OSError:
                pass
            # the wire's int16 planes stay int16 all the way into the
            # channelizer kernel's window DMAs (r5 native ingest path —
            # no float conversion, half the host→device transfer)
            buf = (np.concatenate([buf[0], pl_[0]]),
                   np.concatenate([buf[1], pl_[1]]))
            while len(buf[0]) >= cfg.chunk_in:
                yield (buf[0][:cfg.chunk_in], buf[1][:cfg.chunk_in])
                buf = (buf[0][cfg.chunk_in:], buf[1][cfg.chunk_in:])
    finally:
        client.close()


def run_monitor(args) -> int:
    """CLI entry: monitor a wideband IQ WAV or a live (fake) KiwiSDR."""
    n_chan = args.n_chan
    if getattr(args, "input", None):
        t, z = wav_io.read_kiwi_iq_wav(args.input)
        fs = int(round(1.0 / np.median(np.diff(t[:10000]))))
    else:
        fs = getattr(args, "rate", 12000) * n_chan
    fs_eff = (fs // n_chan) * n_chan
    chunk_in = max(n_chan, (min(fs_eff, fs_eff // 4) // n_chan) * n_chan)
    cfg = wideband.WidebandConfig(fs_in=fs_eff, n_chan=n_chan,
                                  chunk_in=chunk_in, mode=args.mode,
                                  audio_rate=4 * fs_eff // n_chan)
    core = MonitorCore(cfg, thresh_db=args.thresh,
                       device=getattr(args, "device", None))
    if getattr(args, "select", None) is not None:
        core.select_freq(args.select * 1e3)
    if getattr(args, "record", None):
        core.start_recording(args.record)
    src = (_wav_source(z, cfg) if getattr(args, "input", None)
           else _kiwi_source(args, cfg))

    interactive = sys.stdout.isatty() and not getattr(args, "headless",
                                                      False)
    poll = None
    if interactive:
        from supersdr_tpu_torch.apps.live_tui import stdin_keys
        poll = stdin_keys(mouse=False)
    try:
        for chunk in src:
            core.push(chunk)
            if interactive:
                sys.stdout.write("\x1b[2J\x1b[H"
                                 + "\n".join(core.render_lines()) + "\n")
                sys.stdout.flush()
                for key in poll():
                    if not core.handle_key(key):
                        raise KeyboardInterrupt
            elif core.chunks % max(1, getattr(args, "print_every", 4)) == 0:
                print("\n".join(core.render_lines()))
            if getattr(args, "max_chunks", 0) and \
                    core.chunks >= args.max_chunks:
                break
    except KeyboardInterrupt:
        pass
    finally:
        if poll is not None and hasattr(poll, "restore"):
            poll.restore()
        out = core.stop_recording()
        if out:
            print(f"recorded {out}")
    print("\n".join(core.render_lines()))
    return 0
