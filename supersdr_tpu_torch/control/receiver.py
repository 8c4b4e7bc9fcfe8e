"""Receiver controller: the control surface of a virtual receiver, backed
by the port's receiver chain on a device instead of a KiwiSDR server
(counterpart of the reference's `control/receiver.py`, knob for knob).

Mirrors the knobs and semantics of the reference `kiwi_sound`
(utils_supersdr.py:901-1043):

  * dial frequency (kHz), mode, passband deltas, `change_passband`
  * AGC parameter set: on/hang/thresh/slope/decay/manGain with the
    per-mode decay memory (decay_cw vs decay_other) and the 400..8000 ms
    clamp of `change_agc_delay` (utils:1009-1024)
  * volume (0..100+), stereo balance with the reference's squared-gain
    pan law, mute (supersdr.py:386-418; utils:1117-1138)
  * TX-mute: RSSI above -20 dBm mutes output for 15 frames
    (utils:921-925,1141-1147)

Where `kiwi_sound` sends `SET mod=…`/`SET agc=…` strings, this rebuilds
the chain's parameters on the receiver's device via `refresh_params`. It
also implements the `TunableRig` protocol so the rigctld emulator can
drive it from fldigi/wsjtx.

The receiver runs on `device` (default: the current CUDA device, as every
constructor of the port; `device="cpu"` runs the plain versions). Each
chunk reaches the card from a pinned host buffer (`device.PinnedStager`);
`process_dispatch` returns device tensors without waiting for the card and
`process_fetch` copies them to the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from supersdr_tpu_torch.control.bandplan import get_auto_mode
from supersdr_tpu_torch.device import PinnedStager, default_device
from supersdr_tpu_torch.ops import passband as pb
from supersdr_tpu_torch.ops import smeter
from supersdr_tpu_torch.runtime import chain


@dataclass
class Flags:
    """Global link flags (reference `flags`, utils_supersdr.py:116-141)."""
    auto_mode: bool = True
    wf_cat_link: bool = True
    wf_snd_link: bool = False
    cat_snd_link: bool = True
    dualrx: bool = False
    s_meter_show: bool = False
    show_eibi: bool = False
    show_dxcluster: bool = False


@dataclass
class AGCSettings:
    on: bool = True
    hang: bool = False
    thresh: int = -80
    slope: int = 0
    decay: int = 4000
    gain: int = 50
    decay_cw: int = 1000
    decay_other: int = 4000
    MIN_DELAY: int = 400
    MAX_DELAY: int = 8000

    def change_delay(self, delta: int, mode: str) -> None:
        """±decay with clamping; remembered per mode family
        (change_agc_delay, utils:1009-1017)."""
        if delta < 0:
            if self.decay > self.MIN_DELAY:
                self.decay += delta
        else:
            if self.decay < self.MAX_DELAY:
                self.decay += delta
        if mode.upper() == "CW":
            self.decay_cw = self.decay
        else:
            self.decay_other = self.decay

    def select_mode(self, mode: str) -> None:
        """Mode switch restores that family's decay (set_mode_freq_pb,
        utils:1026-1027)."""
        self.decay = self.decay_cw if mode.upper() == "CW" else self.decay_other

    def kwargs(self) -> dict:
        return dict(on=self.on, hang=self.hang, thresh_db=float(self.thresh),
                    slope_db=float(self.slope), decay_ms=float(self.decay),
                    man_gain_db=float(self.gain))


MAX_RSSI_BEFORE_MUTE = -20.0
MUTING_DELAY_FRAMES = 15


@dataclass
class Receiver:
    """One virtual receiver tuned inside a capture span."""
    cfg: chain.ChainConfig = field(default_factory=chain.ChainConfig)
    center_freq_khz: float = 14200.0   # capture center the IQ is based at
    freq: float = 14200.0              # dial frequency, kHz
    radio_mode: str = "USB"
    delta_low: float = 0.0
    delta_high: float = 0.0
    volume: int = 100
    audio_balance: float = 0.0         # -1 (left) .. +1 (right)
    muted: bool = False
    agc: AGCSettings = field(default_factory=AGCSettings)
    # native equivalents of `SET squelch=.. max=..` / `SET nb=.. th=..`
    squelch_on: bool = False
    squelch_thresh_db: float = -100.0
    nb_on: bool = False
    nb_thresh: float = 6.0
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = default_device(self.device)
        self._stager = PinnedStager(self.device)
        self.rssi = -127.0
        self.smoothed_rssi = -127.0
        self.mute_counter = 0
        self.adc_overflow = False
        self.params = None
        self.state = None
        self.rev = 0             # bumped on every param rebuild (lets a
                                 # batched program detect stale slots)
        self.lc, self.hc = self.change_passband(self.delta_low,
                                                self.delta_high)
        self.refresh_params()

    # -------------------------------------------------- control surface

    def change_passband(self, delta_low: float, delta_high: float
                        ) -> tuple[float, float]:
        self.delta_low, self.delta_high = delta_low, delta_high
        self.lc, self.hc = pb.supersdr_passband(self.radio_mode, delta_low,
                                                delta_high)
        return self.lc, self.hc

    def adjust_passband(self, which: str, shift: bool = False,
                        ctrl: bool = False) -> bool:
        """J ('low') / K ('high') key semantics incl. width clamping
        (supersdr.py:307-373). Returns True if the passband changed."""
        step = pb.passband_step(self.radio_mode, shift)
        if which == "low":
            # J key: delta is -100 by default, +100 with SHIFT
            # (supersdr.py:311) — the inverse of the K key convention
            step = -step
        old = (self.delta_low, self.delta_high)
        dl, dh = self.delta_low, self.delta_high
        if ctrl:
            dl += step
            dh -= step if self.radio_mode != "AM" else -step
        elif which == "low":
            dl += step
        else:
            dh += step
        dl, dh = pb.clamp_deltas(self.radio_mode, dl, dh, *old)
        if (dl, dh) == old:
            return False
        self.change_passband(dl, dh)
        self.refresh_params()
        return True

    def reset_passband(self) -> None:
        self.change_passband(0.0, 0.0)
        self.refresh_params()

    def set_mode(self, mode: str) -> None:
        mode = mode.upper()
        if mode not in pb.MODES:
            raise pb.UnknownModulation(mode)
        self.radio_mode = mode
        self.agc.select_mode(mode)
        self.change_passband(self.delta_low, self.delta_high)
        self.refresh_params()

    def tune(self, freq_khz: float, auto_mode: bool = False) -> None:
        self.freq = freq_khz
        if auto_mode:
            new_mode = get_auto_mode(freq_khz)
            if new_mode != self.radio_mode:
                self.radio_mode = new_mode
                self.agc.select_mode(new_mode)
                self.change_passband(self.delta_low, self.delta_high)
        self.refresh_params()

    def set_agc_params(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self.agc, k, v)
        self.refresh_params()

    @property
    def freq_offset_hz(self) -> float:
        return (self.freq - self.center_freq_khz) * 1000.0

    def refresh_params(self) -> None:
        """Rebuild the chain parameters on the device (host-side design;
        an NB or squelch toggle switches the chain's static config)."""
        if self.nb_on != self.cfg.blanker_enabled or \
                self.squelch_on != self.cfg.squelch_enabled:
            import dataclasses
            # state shapes are blanker/squelch-independent; the stream
            # continues
            self.cfg = dataclasses.replace(self.cfg,
                                           blanker_enabled=self.nb_on,
                                           squelch_enabled=self.squelch_on)
        self.params = chain.make_params(
            self.cfg, freq_offset_hz=self.freq_offset_hz,
            low_cut=self.lc, high_cut=self.hc,
            agc_kwargs=self.agc.kwargs(),
            squelch_kwargs=dict(enabled=self.squelch_on,
                                thresh_db=self.squelch_thresh_db),
            blanker_kwargs=dict(enabled=self.nb_on,
                                thresh_ratio=self.nb_thresh),
            device=self.device)
        self.rev += 1
        if self.state is None:
            self.state = chain.init_state(self.cfg, device=self.device)

    # --------------------------------------------------------- audio path

    def process_dispatch(self, iq_block: np.ndarray):
        """Queue one IQ chunk on the device WITHOUT fetching: the chunk
        goes up from a pinned buffer and the returned output holds device
        tensors; pair with `process_fetch` (the engine's pipeline_depth
        mode overlaps device compute of block k with the readback of
        block k-1)."""
        iq = self._stager.put(np.asarray(iq_block, np.complex64))
        self.state, out = chain.process(self.cfg, self.params, self.state,
                                        iq)
        return out

    def post_audio(self, audio: np.ndarray, rssi_last: float) -> np.ndarray:
        """Host-side post-processing shared by the serial and batched
        (dual-RX) paths: RSSI bookkeeping, volume, TX-mute window
        (utils:1141-1147)."""
        self.rssi = float(rssi_last)
        self.smoothed_rssi = float(smeter.smooth(
            torch.tensor(self.smoothed_rssi, dtype=torch.float32),
            torch.tensor(self.rssi, dtype=torch.float32)))
        audio = np.asarray(audio) * (self.volume / 100.0)
        if self.rssi > MAX_RSSI_BEFORE_MUTE:
            self.mute_counter = MUTING_DELAY_FRAMES
        elif self.mute_counter > 0:
            self.mute_counter -= 1
        if self.mute_counter > 0 or self.muted:
            audio = audio * 0.0
        return audio

    def process_fetch(self, out):
        """Copy a dispatched chunk's audio to the host (this waits for the
        card) with volume and TX-mute applied (host-side
        post-processing)."""
        return self.post_audio(out.audio.cpu().numpy(),
                               float(out.rssi[-1].cpu()))

    def process(self, iq_block: np.ndarray):
        """Demodulate one IQ chunk; returns float32 audio at the audio
        rate with volume and TX-mute applied."""
        return self.process_fetch(self.process_dispatch(iq_block))

    def stereo(self, audio: np.ndarray) -> np.ndarray:
        """Mono → stereo with the reference's squared pan law
        (utils:1136-1138)."""
        left = min(1.0 - self.audio_balance, 1.0) ** 2
        right = min(1.0 + self.audio_balance, 1.0) ** 2
        return np.stack([audio * left, audio * right], axis=-1)

    # ------------------------------------------------ TunableRig protocol

    def get_frequency(self) -> float:
        return self.freq

    def get_mod(self) -> str:
        return self.radio_mode.lower()

    def get_lowcut(self) -> int:
        return int(self.lc)

    def get_highcut(self) -> int:
        return int(self.hc)

    def set_mod(self, mod: str, lc: int | None, hc: int | None,
                freq_khz: float) -> None:
        mode = mod.upper()
        if mode not in pb.MODES:
            mode = "USB"
        self.radio_mode = mode
        self.freq = freq_khz
        if lc is None or hc is None:
            self.change_passband(self.delta_low, self.delta_high)
        else:
            self.lc, self.hc = lc, hc
        self.refresh_params()
