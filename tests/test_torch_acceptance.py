"""The reference's independent end-to-end acceptance checks, run on the
port.

The JAX package holds itself to a scipy oracle of the documented
semantics (tests/test_golden_oracle.py), to the committed off-air-style
KiwiSDR IQ WAV (tests/test_offair_fixture.py) and to simulated sessions
with the real chain under the engine (tests/test_soak.py). Here the same
inputs, oracles, bounds and sessions go through the port: its WAV reader,
`runtime/chain.run_offline` and `control/receiver.Receiver` on the CPU,
with the oracle's 12 kHz audio lifted to 48 kHz by the port's own
interpolator (`ops/resample`), the golden tests' convention of a shared
interpolator. Bounds: ≥ 40 dB against the oracle (BASELINE.md's audio
fidelity bound), the fixture's program tones in order, and no dropped
frame in either session.
"""

import os

import numpy as np
import scipy.signal as sps
import torch

from supersdr_tpu_torch.io import wav
from supersdr_tpu_torch.ops import resample
from supersdr_tpu_torch.runtime import chain
from supersdr_tpu_torch.runtime.engine import (EngineConfig, SourceClosed,
                                               StreamEngine)
from supersdr_tpu_torch.runtime.governor import (DriftCompensator,
                                                 LatencyGovernor)
from test_golden_oracle import (FS, multitone, scipy_am_demod,
                                scipy_ssb_demod, snr_db)
from test_offair_fixture import FIXTURE, TONES
from test_soak import FRAME, MS_PER_FRAME, RATE, SimSession
from test_soak import SourceClosed as RefSourceClosed

ORACLE_DB = 40.0
AGC_OFF = dict(on=False)


def upsample_port(audio12):
    """12 kHz oracle audio through the port's ×4 interpolator."""
    plan, P = resample.design_interp(FS, 4 * FS)
    _, y = resample.interpolate(
        plan, torch.from_numpy(np.asarray(P, np.float32)),
        resample.init_carry(plan, device="cpu"),
        torch.from_numpy(np.asarray(audio12, np.float32)))
    return y.numpy()


def _demod(z, mode, agc_kwargs=None):
    cfg = chain.ChainConfig(mode=mode, chunk=4096, os_block=4096)
    params = chain.make_params(cfg, agc_kwargs=agc_kwargs, device="cpu")
    _, audio, _ = chain.run_offline(cfg, params, z.astype(np.complex64))
    return audio


def _through_wav(tmp_path, name, z):
    path = tmp_path / name
    wav.write_kiwi_iq_wav(path, z, FS)
    return wav.read_kiwi_iq_wav(path)[1]


def test_usb_matches_scipy_oracle(tmp_path, rng):
    _, msg = multitone(rng, [(400, 0.5, 0.1), (1100, 0.4, 1.3),
                             (1900, 0.3, 2.1), (2500, 0.2, 0.7)])
    z2 = _through_wav(tmp_path, "usb.wav",
                      (0.3 * sps.hilbert(msg)).astype(np.complex64))
    audio = _demod(z2, "USB", AGC_OFF)
    assert snr_db(audio, upsample_port(scipy_ssb_demod(z2, 30, 3000))) \
        > ORACLE_DB


def test_am_matches_scipy_oracle(tmp_path, rng):
    _, msg = multitone(rng, [(300, 0.3, 0.0), (800, 0.25, 0.8),
                             (2000, 0.2, 1.9)])
    z2 = _through_wav(tmp_path, "am.wav",
                      (0.4 * (1.0 + msg)).astype(np.complex64))
    audio = _demod(z2, "AM", AGC_OFF)
    assert snr_db(audio, upsample_port(scipy_am_demod(z2, 5900))) \
        > ORACLE_DB


def test_lsb_matches_scipy_oracle(rng):
    _, msg = multitone(rng, [(500, 0.5, 0.4), (1500, 0.35, 2.2)])
    z = (0.3 * np.conj(sps.hilbert(msg))).astype(np.complex64)
    audio = _demod(z, "LSB", AGC_OFF)
    assert snr_db(audio, upsample_port(scipy_ssb_demod(z, -3000, -30))) \
        > ORACLE_DB


def offair_oracle_db(audio, z):
    """The fixture's oracle (firwin lowpass, envelope, the documented DC
    blocker) and the reference test's lag search; returns the best SNR."""
    y = sps.lfilter(sps.firwin(513, 5900, fs=FS), 1.0, z)
    ref = upsample_port(sps.lfilter([1.0, -1.0], [1.0, -0.999], np.abs(y)))
    n = min(len(audio), len(ref))
    a, b = audio[:n], ref[:n]
    best = -np.inf
    for lag in range(-64, 65):
        aa = a[max(lag, 0): n + min(lag, 0)]
        bb = b[max(-lag, 0): n - max(lag, 0)]
        aa = aa[48000:-4000] - aa[48000:-4000].mean()
        bb = bb[48000:-4000] - bb[48000:-4000].mean()
        g = np.dot(aa, bb) / max(np.dot(bb, bb), 1e-30)
        err = aa - g * bb
        best = max(best, 10 * np.log10(np.dot(g * bb, g * bb)
                                       / max(np.dot(err, err), 1e-30)))
    return best


def test_fixture_am_demod_vs_oracle_40db():
    _, z = wav.read_kiwi_iq_wav(FIXTURE)
    audio = _demod(z, "AM", AGC_OFF)
    best = offair_oracle_db(audio, z)
    assert best > ORACLE_DB, best


def program_tone_levels(audio):
    """(500, 900, 1700 Hz levels, the 2.5-5 kHz floor) past the AGC's
    transient, as the reference's tone test reads them."""
    a = audio[48000:]
    sp = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    freqs = np.fft.rfftfreq(len(a), 1.0 / 48000)

    def level(f):
        i = np.argmin(np.abs(freqs - f))
        return sp[i - 2: i + 3].max()
    floor = np.median(sp[(freqs > 2500) & (freqs < 5000)])
    return [level(f) for f in TONES], floor


def test_fixture_program_tones_recovered():
    _, z = wav.read_kiwi_iq_wav(FIXTURE)
    (l500, l900, l1700), floor = program_tone_levels(_demod(z, "AM"))
    assert l500 > l900 > l1700 > 10 * floor


def run_session_port_chain(total_frames, outage_at=None, outage_ms=0.0):
    """The reference's real-chain soak session with the port's receiver
    (`control/receiver.Receiver` on the CPU) as the engine's process
    callback: an AM station at +1 kHz, 512-sample frames paced by the
    simulated clock. The session's disconnect (the reference engine's
    SourceClosed) reaches the port's engine as its own."""
    from supersdr_tpu_torch.control.receiver import Receiver

    cfg = chain.ChainConfig(mode="AM", iq_rate=12000, audio_rate=48000,
                            chunk=FRAME, os_block=FRAME, n_taps=129)
    rx = Receiver(cfg=cfg, center_freq_khz=1000.0, freq=1001.0,
                  radio_mode="AM", device="cpu")
    sim = SimSession(total_frames, outage_at, outage_ms)
    n0 = {"n": 0}
    base_factory = sim.factory

    def factory():
        def toned():
            try:
                for _ in base_factory():
                    t = (n0["n"] + np.arange(FRAME)) / RATE
                    n0["n"] += FRAME
                    yield (0.4 * (1 + 0.5 * np.sin(2 * np.pi * 400 * t))
                           * np.exp(2j * np.pi * 1000.0 * t)
                           ).astype(np.complex64)
            except RefSourceClosed:
                raise SourceClosed() from None
        return toned()

    seen = {"max": 0.0, "frames": 0}

    def process(block):
        a = np.asarray(rx.process(block), np.float32)
        assert np.isfinite(a).all()
        seen["max"] = max(seen["max"], float(np.abs(a).max()))
        seen["frames"] += 1
        return a

    gov = LatencyGovernor(buffer_frames=10, ms_per_frame=MS_PER_FRAME)
    eng = StreamEngine(factory, process=process,
                       config=EngineConfig(buffer_frames=10,
                                           backoff_closed_s=0.0),
                       governor=gov,
                       drift=DriftCompensator(12000, 12000.6, FRAME),
                       clock=sim.clock)
    sim.engine = eng
    eng.run()
    return sim, eng, gov, seen


def test_soak_real_chain_steady_state():
    frames = int(65_000 / MS_PER_FRAME)
    sim, eng, gov, seen = run_session_port_chain(frames)
    assert sim.now_ms >= 60_000
    assert eng.dropped_frames == 0
    assert not gov.late
    assert seen["frames"] >= frames - 5
    assert seen["max"] > 0.01


def test_soak_real_chain_disconnect_recovery():
    frames = int(70_000 / MS_PER_FRAME)
    sim, eng, gov, seen = run_session_port_chain(
        frames, outage_at=frames // 3, outage_ms=2_000.0)
    assert sim.sent == frames
    assert eng.reconnects == 1
    assert eng.dropped_frames == 0
    assert not gov.late
    assert seen["max"] > 0.01


def test_cli_demod_on_the_fixture_vs_oracle_40db(tmp_path):
    """The user's path to the same result: `cli demod --mode AM --agc-off`
    on the fixture writes a WAV whose audio meets the oracle at ≥ 40 dB
    (chip_smoke.py's `variants` phase runs this call on the card)."""
    from supersdr_tpu_torch import cli
    out = tmp_path / "am.wav"
    assert cli.main(["demod", FIXTURE, "-o", str(out), "--mode", "AM",
                     "--agc-off", "--device", "cpu"]) == 0
    audio, rate = wav.read_audio_wav(out)
    assert rate == 4 * FS
    _, z = wav.read_kiwi_iq_wav(FIXTURE)
    best = offair_oracle_db(np.asarray(audio, np.float64).reshape(-1), z)
    assert best > ORACLE_DB, best
