"""The port's batched dual RX against the JAX package's, on the CPU.

- `DualChain` on tests/test_dualrx_profiling.py::test_dual_rx_ssb_plus_cw's
  inputs (a USB tone at +1.4 kHz and a CW carrier 3 kHz up, AGC off,
  8192-sample chunks): both slots ≥ 80 dB against the reference's
  `DualChain`, RSSI within 0.01 dB.
- an inactive SUB is exactly zero while its state keeps threading.
- `refresh` writes into the tensors of the first refresh: every
  parameter leaf keeps its storage, shape and dtype across SUB add and
  drop, a mode change and a retune (the port's counterpart of the
  reference's single jit signature, tests/test_live_tui.py), and the
  outputs still match the reference's after each event.
"""

import dataclasses

import numpy as np
import pytest
import torch

from supersdr_tpu.runtime import chain as jchain
from supersdr_tpu.runtime import dualrx as jdual
from supersdr_tpu_torch.runtime import chain as tchain
from supersdr_tpu_torch.runtime import dualrx as tdual

AUDIO_DB = 80.0
RSSI_DB = 0.01
CHUNK = 8192


class _Agc:
    def __init__(self, **kw):
        self.kw = kw

    def kwargs(self):
        return dict(self.kw)


@dataclasses.dataclass
class _Slot:
    """The Receiver attributes `DualChain.refresh` reads."""
    radio_mode: str
    freq_offset_hz: float
    lc: float
    hc: float
    agc: _Agc = dataclasses.field(default_factory=lambda: _Agc(on=False))
    squelch_on: bool = False
    squelch_thresh_db: float = -100.0
    nb_on: bool = False
    nb_thresh: float = 6.0


USB = _Slot("USB", 0.0, 30.0, 3000.0)
CW = _Slot("CW", 3000.0, 400.0, 800.0)


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _iq(n=32768, fs=12000):
    t = np.arange(n) / fs
    usb_tone = 0.4 * np.exp(2j * np.pi * 1400 * t)
    cw_carrier = 0.1 * np.exp(2j * np.pi * (3000 + 600) * t)
    return (usb_tone + cw_carrier).astype(np.complex64)


def _pair():
    cfg = dict(mode="USB", chunk=CHUNK, os_block=CHUNK)
    return (jdual.DualChain(jchain.ChainConfig(**cfg)),
            tdual.DualChain(tchain.ChainConfig(**cfg), device="cpu"))


def _step(jd, td, blk, active):
    ja, jr = jd.process(blk)
    ta, tr = td.process(blk)
    assert ta.shape == ja.shape and ta.dtype == np.float32
    for s in range(2):
        if active[s]:
            assert _snr(ja[s], ta[s]) >= AUDIO_DB, s
        else:
            assert not ta[s].any()
    np.testing.assert_allclose(tr, np.asarray(jr), atol=RSSI_DB, rtol=0)
    return ta


def test_dual_rx_ssb_plus_cw_matches_reference():
    jd, td = _pair()
    jd.refresh([USB, CW], [True, True])
    td.refresh([USB, CW], [True, True])
    iq = _iq()
    for i in range(0, len(iq), CHUNK):
        _step(jd, td, iq[i:i + CHUNK], (True, True))
    # after the ramp-up: each slot hears its own signal
    a = td.process(iq[:CHUNK])[0]
    for s, f in ((0, 1400.0), (1, 600.0)):
        spec = np.abs(np.fft.rfft(a[s][-16384:]))
        assert abs(np.argmax(spec) * 48000 / 16384 - f) < 10


def _leaves(tree, out=None):
    out = [] if out is None else out
    if isinstance(tree, tuple):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def test_sub_off_is_silent_and_keeps_threading():
    jd, td = _pair()
    iq = _iq()
    for d in (jd, td):
        d.refresh([USB, CW], [True, False])
    _step(jd, td, iq[:CHUNK], (True, False))
    _step(jd, td, iq[CHUNK:2 * CHUNK], (True, False))
    # SUB on: its state has threaded through the muted chunks
    for d in (jd, td):
        d.refresh([USB, CW], [True, True])
    _step(jd, td, iq[2 * CHUNK:3 * CHUNK], (True, True))


def test_refresh_keeps_every_tensor_across_events():
    jd, td = _pair()
    iq = _iq(8 * CHUNK)
    events = [
        ([USB, USB], [True, False]),                     # SUB off
        ([USB, CW], [True, True]),                       # SUB on
        ([CW, USB], [True, True]),                       # swap MAIN/SUB
        ([_Slot("AM", 0.0, -6000.0, 6000.0), USB], [True, True]),  # mode
        ([_Slot("AM", 1500.0, -6000.0, 6000.0, _Agc(decay_ms=800.0)),
          USB], [True, True]),                           # retune, AGC
        ([_Slot("NBFM", -500.0, -6000.0, 6000.0), CW], [True, False]),
    ]
    jd.refresh(*events[0])
    td.refresh(*events[0])
    ref = [(t.data_ptr(), t.shape, t.dtype) for t in _leaves(td.params)]
    mask_ptr = td._mask.data_ptr()
    for k, (slots, active) in enumerate(events):
        jd.refresh(slots, active)
        td.refresh(slots, active)
        assert [(t.data_ptr(), t.shape, t.dtype)
                for t in _leaves(td.params)] == ref, k
        assert td._mask.data_ptr() == mask_ptr
        _step(jd, td, iq[k * CHUNK:(k + 1) * CHUNK], active)
    assert td.params.mode_id.dtype == torch.int32
    assert td.params.mode_id.tolist() == [2, 0]


def test_dualrx_refuses_iq_and_non_fft_passbands():
    for kw in (dict(mode="IQ"), dict(passband_impl="matmul")):
        cfg = tchain.ChainConfig(chunk=CHUNK, os_block=CHUNK, **kw)
        with pytest.raises(ValueError):
            tdual.DualChain(cfg, device="cpu")
