"""The port's receiver controller and link state machine against the JAX
package's, on the CPU.

- `Receiver` against the reference's `Receiver` on the same IQ blocks
  through retunes, mode changes, passband and AGC edits and NB/squelch
  toggles: audio ≥ 80 dB, RSSI and the smoothed S-meter within 0.01 dB
  (both chains float32; tests/test_torch_chain states why 80 dB).
- the reference's tests/test_receiver_links.py cases, run on the port's
  `Receiver` and `LinkController` with the same assertions.
- the S-meter helpers of `ops/smeter` against the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersdr_tpu.control import receiver as jrx
from supersdr_tpu.runtime import chain as jchain
from supersdr_tpu.ops import smeter as jsm
from supersdr_tpu_torch.control.links import LinkController
from supersdr_tpu_torch.control.panadapter import Panadapter
from supersdr_tpu_torch.control.receiver import AGCSettings, Flags, Receiver
from supersdr_tpu_torch.ops import smeter as tsm
from supersdr_tpu_torch.runtime import chain

AUDIO_DB = 80.0
RSSI_DB = 0.01


def small_cfg(mode="USB"):
    return chain.ChainConfig(mode=mode, chunk=2048, os_block=2048, n_taps=129)


def make_rx(mode="USB", freq=14200.0):
    return Receiver(cfg=small_cfg(mode), center_freq_khz=freq, freq=freq,
                    radio_mode=mode, device="cpu")


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _iq(n, seed, fs=12000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    env = 1 + 0.8 * np.sin(2 * np.pi * 3 * t)
    z = (0.05 * env * np.exp(2j * np.pi * 1000 * t)
         + 0.02 * np.exp(2j * np.pi * -2300 * t)
         + 0.002 * (rng.normal(size=n) + 1j * rng.normal(size=n)))
    return z.astype(np.complex64)


# each event applies to both receivers before the next block
EVENTS = [
    lambda r: None,
    lambda r: r.tune(14201.3),
    lambda r: r.set_mode("CW"),
    lambda r: r.adjust_passband("high", shift=True),
    lambda r: r.set_agc_params(decay=800, thresh=-90),
    lambda r: r.set_mode("AM"),
    lambda r: setattr(r, "volume", 60),
    lambda r: r.tune(14198.0, auto_mode=False),
    lambda r: (setattr(r, "nb_on", True), r.refresh_params()),
    lambda r: (setattr(r, "squelch_on", True),
               setattr(r, "squelch_thresh_db", -40.0), r.refresh_params()),
    lambda r: r.set_mode("LSB"),
    lambda r: r.set_mod("usb", 200, 2800, 14200.5),
]


@pytest.mark.parametrize("split", [False, True])
def test_receiver_matches_reference(split):
    """The same blocks and control events through both receivers;
    `split` runs the port through process_dispatch / process_fetch, as
    the engine's pipelined mode does."""
    jr = jrx.Receiver(cfg=jchain.ChainConfig(mode="USB", chunk=2048,
                                             os_block=2048, n_taps=129),
                      center_freq_khz=14200.0, freq=14200.0,
                      radio_mode="USB")
    tr = make_rx("USB")
    iq = _iq(2048 * len(EVENTS), 1)
    for k, ev in enumerate(EVENTS):
        ev(jr)
        ev(tr)
        blk = iq[k * 2048:(k + 1) * 2048]
        ja = jr.process(blk)
        if split:
            out = tr.process_dispatch(blk)
            assert out.audio.device.type == "cpu"
            ta = tr.process_fetch(out)
        else:
            ta = tr.process(blk)
        assert ta.shape == ja.shape and ta.dtype == ja.dtype
        if np.linalg.norm(ja) == 0:
            assert np.linalg.norm(ta) == 0, k
        else:
            assert _snr(ja, ta) >= AUDIO_DB, k
        assert abs(tr.rssi - jr.rssi) <= RSSI_DB, k
        assert abs(tr.smoothed_rssi - jr.smoothed_rssi) <= RSSI_DB, k
        assert (tr.lc, tr.hc, tr.radio_mode, tr.mute_counter) == \
            (jr.lc, jr.hc, jr.radio_mode, jr.mute_counter)
    assert tr.rev == jr.rev
    np.testing.assert_allclose(tr.stereo(ta), jr.stereo(ja), atol=1e-4)


def test_smeter_helpers_match_reference():
    rng = np.random.default_rng(2)
    rssi = rng.uniform(-140, 10, size=257).astype(np.float32)
    prev = rng.uniform(-130, 0, size=257).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        tsm.encode_smeter_u16(t(rssi)).numpy().astype(np.int64),
        np.asarray(jsm.encode_smeter_u16(jnp.asarray(rssi))).astype(np.int64))
    raw = rng.integers(0, 65536, size=257).astype(np.uint16)
    np.testing.assert_array_equal(
        tsm.decode_smeter_u16(t(raw.astype(np.int32))).numpy(),
        np.asarray(jsm.decode_smeter_u16(jnp.asarray(raw))))
    np.testing.assert_array_equal(
        tsm.smooth(t(prev), t(rssi)).numpy(),
        np.asarray(jsm.smooth(jnp.asarray(prev), jnp.asarray(rssi))))
    np.testing.assert_array_equal(
        tsm.smooth(t(prev), t(rssi), 0.3, 0.05).numpy(),
        np.asarray(jsm.smooth(jnp.asarray(prev), jnp.asarray(rssi),
                              0.3, 0.05)))
    np.testing.assert_array_equal(tsm.s_units(t(rssi)).numpy(),
                                  np.asarray(jsm.s_units(jnp.asarray(rssi))))


# ---- tests/test_receiver_links.py's cases on the port

def test_receiver_passband_adjust():
    rx = make_rx("USB")
    assert (rx.lc, rx.hc) == (30, 3000)
    assert rx.adjust_passband("high")          # K: +100 on high cut
    assert (rx.lc, rx.hc) == (30, 3100)
    assert rx.adjust_passband("low")           # J: -100 on low cut
    assert (rx.lc, rx.hc) == (-70, 3100)
    assert rx.adjust_passband("low", shift=True)
    assert (rx.lc, rx.hc) == (30, 3100)


def test_receiver_passband_width_clamp():
    rx = make_rx("CW")
    # CW step is 20 Hz; default width 400; narrow until the 50 Hz floor
    for _ in range(12):
        rx.adjust_passband("high", shift=True)  # -20 each
    width = rx.hc - rx.lc
    assert width >= 50
    changed = rx.adjust_passband("high", shift=True)
    if width - 20 < 50:
        assert not changed


def test_receiver_mode_switch_decay_memory():
    rx = make_rx("USB")
    assert rx.agc.decay == 4000
    rx.set_mode("CW")
    assert rx.agc.decay == 1000
    rx.agc.change_delay(-200, "CW")
    assert rx.agc.decay == 800
    rx.set_mode("USB")
    assert rx.agc.decay == 4000
    rx.set_mode("CW")
    assert rx.agc.decay == 800


def test_receiver_agc_delay_clamp():
    a = AGCSettings()
    a.decay = 500
    a.change_delay(-200, "USB")
    assert a.decay == 300  # steps below min only when above it
    a.change_delay(-200, "USB")
    assert a.decay == 300
    a.decay = 7900
    a.change_delay(200, "USB")
    assert a.decay == 8100
    a.change_delay(200, "USB")
    assert a.decay == 8100


def test_receiver_demodulates():
    rx = make_rx("USB")
    fs = 12000
    t = np.arange(8192) / fs
    # modest level: a full-scale tone would (correctly) trip the TX-mute
    iq = (0.05 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    audio = np.concatenate([rx.process(iq[:2048]), rx.process(iq[2048:4096])])
    assert audio.shape == (2 * 2048 * 4,)
    assert np.abs(audio[4096:]).max() > 0.02
    assert -60 < rx.rssi < -25


def test_receiver_tx_mute():
    rx = make_rx("USB")
    fs = 12000
    t = np.arange(2048) / fs
    loud = (30.0 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    audio = rx.process(loud)
    assert rx.rssi > -20
    assert np.abs(audio).max() == 0.0  # muted during TX


def test_receiver_tunable_rig_interface():
    rx = make_rx("USB")
    rx.set_mod("cw", None, None, 7030.0)
    assert rx.radio_mode == "CW"
    assert rx.freq == 7030.0
    assert (rx.get_lowcut(), rx.get_highcut()) == (400, 800)


def test_links_manual_tune_follow():
    rx = make_rx("USB")
    pan = Panadapter(zoom=8, freq_khz=14200)
    lc = LinkController(wf=pan, rx=rx, flags=Flags(wf_snd_link=False,
                                                   auto_mode=True))
    lc.manual_tune(14250.0)
    assert rx.freq == 14250.0
    assert rx.radio_mode == "USB"
    # tune out of span: span shifts to the edge
    out_freq = pan.end_f_khz + 50
    lc.manual_tune(out_freq)
    assert pan.contains(rx.freq) or abs(pan.freq_khz - rx.freq) < pan.span_khz


def test_links_auto_mode_switches():
    rx = make_rx("USB", freq=14200.0)
    pan = Panadapter(zoom=6, freq_khz=7100)
    lc = LinkController(wf=pan, rx=rx, flags=Flags(auto_mode=True))
    lc.manual_tune(7100.0)
    assert rx.radio_mode == "LSB"
    lc.manual_tune(7030.0)
    assert rx.radio_mode == "CW"
    lc.manual_tune(1000.0)
    assert rx.radio_mode == "AM"


def test_links_click_cw_pitch():
    rx = make_rx("CW", freq=7025.0)
    pan = Panadapter(zoom=10, freq_khz=7025)
    lc = LinkController(wf=pan, rx=rx, flags=Flags(auto_mode=False))
    lc.click_tune(512)
    expected = pan.bins_to_khz(512) - 0.6
    assert abs(rx.freq - expected) < 1e-9


class FakeCat:
    def __init__(self):
        self.freq = 14200.0
        self.radio_mode = "USB"
        self.set_calls = []

    def set_freq(self, f):
        self.set_calls.append(("F", f))
        self.freq = f

    def set_mode(self, m):
        self.set_calls.append(("M", m))
        self.radio_mode = m

    def get_mode(self):
        return self.radio_mode

    def get_freq(self):
        return self.freq


def test_links_cat_push_cw_pitch():
    rx = make_rx("CW", freq=7030.0)
    pan = Panadapter(zoom=8, freq_khz=7030)
    cat = FakeCat()
    lc = LinkController(wf=pan, rx=rx, flags=Flags(auto_mode=False))
    lc.cat = cat
    lc.manual_tune(7030.0)
    # CAT gets dial + CW pitch
    assert ("F", 7030.6) in cat.set_calls


def test_links_cat_poll_reverse():
    rx = make_rx("USB", freq=14200.0)
    pan = Panadapter(zoom=8, freq_khz=14200)
    cat = FakeCat()
    lc = LinkController(wf=pan, rx=rx, flags=Flags(auto_mode=False))
    lc.cat = cat
    assert not lc.poll_cat()  # first poll just records the baseline
    cat.freq = 14210.0        # user turned the VFO
    assert lc.poll_cat()
    assert rx.freq == 14210.0
