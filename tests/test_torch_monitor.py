"""The port's wideband monitor (`apps/monitor`) against the JAX package's,
on the CPU.

`MonitorCore` on each tier, fed the same seeded numpy chunks as the
reference's: the squelch-gated activity list names the same channels (by
row on the chan-major tier, by frequency on the planar tier, whose row
order differs between the packages), the smoothed RSSI table agrees
within 0.01 dB (0.05 dB planar fast: the in-kernel power row of
tests/test_torch_wideband_chanmajor.py), and the selected channel's audio
within the tier's bound — ≥ 80 dB on the float32 tiers, ≥ 45 dB fast
planar, ≥ 85 dB quality planar (tests/test_torch_wideband.py) — and its
recorded WAV ≥ 75 dB after int16 rounding (tests/test_torch_cli.py).
`push` brings back to the host only the RSSI row means and the selected
row. The live pump against each package's fake KiwiSDR, and the monitor
over the port's sharded pipeline (`make_mesh(4, device="cpu")`), find the
reference's carriers.
"""

import argparse
import wave

import numpy as np
import pytest
import torch

from supersdr_tpu.apps import monitor as jmon
from supersdr_tpu.runtime import wideband as jwb
from supersdr_tpu_torch.apps.monitor import MonitorCore
from supersdr_tpu_torch.runtime import wideband as twb

N_CHAN = 8
FS = 12_000                      # wideband capture rate (8 × 1.5 kHz)
SMALL = dict(fs_in=FS, n_chan=N_CHAN, chunk_in=FS // 4, mode="AM",
             audio_rate=4 * FS // N_CHAN)
PLANAR = dict(fs_in=512 * 12_000, n_chan=512, chunk_in=512 * 512,
              taps_per=4, n_taps=129, mode="AM")
PLANAR_CARRIERS = (3, 100, 301)                 # PFB bins
AUDIO_DB = {None: 80.0, "fast": 45.0, "quality": 85.0}
RSSI_DB = {None: 0.01, "fast": 0.05, "quality": 0.01}
WAV_DB = 75.0


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _wideband_iq(n, fs=FS):
    """Two AM carriers at channel centers (+1.5 kHz, −3.0 kHz; 200 /
    350 Hz program tones) over a −50 dB noise floor."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / fs
    z = (0.35 * (1 + 0.6 * np.sin(2 * np.pi * 200.0 * t))
         * np.exp(2j * np.pi * 1500.0 * t))
    z = z + (0.18 * (1 + 0.6 * np.sin(2 * np.pi * 350.0 * t))
             * np.exp(-2j * np.pi * 3000.0 * t))
    z = z + 0.003 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return z.astype(np.complex64)


def _planar_iq(n_chunks):
    """AM carriers at PLANAR_CARRIERS' channel centres over a floor ~50 dB
    below them, at 6.144 MHz."""
    fs, C = PLANAR["fs_in"], PLANAR["n_chan"]
    n = n_chunks * PLANAR["chunk_in"]
    rng = np.random.default_rng(4)
    t = np.arange(n) / fs
    z = 2e-3 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    for i, k in enumerate(PLANAR_CARRIERS):
        fk = (k if k < C // 2 else k - C) * (fs / C)
        z = z + 0.1 * (1 + 0.5 * np.sin(2 * np.pi * (300 + 200 * i) * t)) \
            * np.exp(2j * np.pi * fk * t)
    return z.astype(np.complex64).reshape(n_chunks, -1)


def _chunks(z, n):
    return [z[i:i + n] for i in range(0, (len(z) // n) * n, n)]


def _wav(path):
    w = wave.open(str(path))
    a = np.frombuffer(w.readframes(w.getnframes()), np.int16
                      ).astype(np.float64)
    w.close()
    return a


def _pair(kw, tier=None, thresh=-40.0, **core_kw):
    prof = {} if tier is None else twb.PROFILES[tier]
    port = MonitorCore(twb.WidebandConfig(**kw, **prof), thresh_db=thresh,
                       device="cpu", **core_kw)
    ref = jmon.MonitorCore(jwb.WidebandConfig(
        **kw, **({} if tier is None else jwb.PROFILES[tier])),
        thresh_db=thresh, **core_kw)
    return port, ref


def _by_freq(act):
    return sorted((round(f), r) for _, f, r in act)


def _same_activity(got, want, atol):
    """Equal rows and frequencies in the same order; RSSI within atol."""
    assert [(r, f) for r, f, _ in got] == [(r, f) for r, f, _ in want]
    np.testing.assert_allclose([x for _, _, x in got],
                               [x for _, _, x in want], atol=atol, rtol=0)


def _centre_hz(k):
    C, fs = PLANAR["n_chan"], PLANAR["fs_in"]
    return (k if k < C // 2 else k - C) * (fs / C)


@pytest.mark.parametrize("tier", [None, "fast", "quality"],
                         ids=["chanmajor", "planar-fast", "planar-quality"])
def test_core_matches_the_reference(tier, tmp_path):
    if tier is None:
        port, ref = _pair(SMALL)
        chunks = _chunks(_wideband_iq(FS * 2), SMALL["chunk_in"])
        sel_hz = 1500.0
    else:
        port, ref = _pair(PLANAR, tier, thresh=-60.0)
        chunks = list(_planar_iq(2))
        sel_hz = _centre_hz(PLANAR_CARRIERS[1])
        assert twb._planar_active(port.cfg)
    for core, name in ((port, "port"), (ref, "ref")):
        core.select_freq(sel_hz)
        core.start_recording(str(tmp_path / f"{name}.wav"))
    for z in chunks:
        port.push(z)
        ref.push(z)
        # RSSI tables compared by frequency (the row orders may differ)
        pr = port.rssi_rows[np.argsort(port.freqs)]
        jr = ref.rssi_rows[np.argsort(ref.freqs)]
        np.testing.assert_allclose(pr, jr, atol=RSSI_DB[tier], rtol=0)
        pa, ja = _by_freq(port.activity()), _by_freq(ref.activity())
        assert [f for f, _ in pa] == [f for f, _ in ja]
        np.testing.assert_allclose([r for _, r in pa], [r for _, r in ja],
                                   atol=RSSI_DB[tier], rtol=0)
        assert _snr(ref.selected_audio(), port.selected_audio()) \
            >= AUDIO_DB[tier]
    if tier is None:
        _same_activity(port.activity(), ref.activity(), RSSI_DB[tier])
        assert sorted(round(f) for _, f, _ in port.activity()) == [-3000,
                                                                   1500]
    else:
        want = sorted(round(_centre_hz(k)) for k in PLANAR_CARRIERS)
        assert sorted(round(f) for _, f, _ in port.activity()) == want
    assert port.freqs[port.selected] == pytest.approx(sel_hz)
    port.stop_recording()
    ref.stop_recording()
    a, b = _wav(tmp_path / "port.wav"), _wav(tmp_path / "ref.wav")
    assert a.size == b.size == len(chunks) * port.cfg.chunk_per_chan * 4
    assert _snr(b, a) >= min(WAV_DB, AUDIO_DB[tier])
    assert port.render_lines()[0] == ref.render_lines()[0]


def test_int16_wire_planes_equal_the_dequantized_chunks():
    """`(re_i16, im_i16)` chunks (the live source's wire planes) give the
    monitor exactly what the dequantized complex chunks give."""
    z = _wideband_iq(FS)
    q = np.clip(np.round(z * 32768.0 / 2), -32768, 32767)
    re, im = q.real.astype(np.int16), q.imag.astype(np.int16)
    deq = ((re.astype(np.float32) + 1j * im.astype(np.float32))
           / 32768.0).astype(np.complex64)
    a, b = (MonitorCore(twb.WidebandConfig(**SMALL), thresh_db=-46.0,
                        device="cpu") for _ in range(2))
    n = SMALL["chunk_in"]
    for i in range(0, FS, n):
        a.push((re[i:i + n], im[i:i + n]))
        b.push(deq[i:i + n])
        np.testing.assert_array_equal(a.rssi_rows, b.rssi_rows)
        np.testing.assert_array_equal(a.selected_audio(), b.selected_audio())
    assert a.activity() == b.activity() and a.activity()


def test_push_copies_only_the_rssi_means_and_the_selected_row(monkeypatch,
                                                               tmp_path):
    """The audio stays where it was made: each push brings the RSSI row
    means (n_chan floats) to the host, and the selected row when it is
    recorded — never the whole [rows, time] block."""
    cfg = twb.WidebandConfig(**PLANAR, **twb.PROFILES["fast"])
    core = MonitorCore(cfg, thresh_db=-60.0, device="cpu")
    sizes = []
    host = MonitorCore._host

    def spy(t):
        sizes.append(tuple(t.shape))
        return host(t)
    monkeypatch.setattr(MonitorCore, "_host", staticmethod(spy))
    core.start_recording(str(tmp_path / "sel.wav"))
    core.push(_planar_iq(1)[0])
    assert sizes == [(cfg.n_chan,), (cfg.chunk_per_chan * 4,)]
    assert isinstance(core._last_audio, torch.Tensor)
    core.stop_recording()


def test_device_follows_the_params_or_the_card(monkeypatch):
    cfg = twb.WidebandConfig(**SMALL)
    params = twb.make_params(cfg, device="cpu")
    core = MonitorCore(cfg, params=params)
    assert core.device == torch.device("cpu")
    assert core.state.pfb_carry.re.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        MonitorCore(cfg)


def test_monitor_keys_and_hysteresis():
    core = MonitorCore(twb.WidebandConfig(**SMALL), thresh_db=-40.0,
                       hyst_db=10.0, device="cpu")
    z = _wideband_iq(FS)
    for c in _chunks(z, SMALL["chunk_in"]):
        core.push(c)
    rows = [r for r, _, _ in core.activity()]
    core.select_row(rows[0])
    assert core.handle_key("j")
    assert core.selected == rows[1 % len(rows)]
    assert core.handle_key("k")
    assert core.selected == rows[0]
    assert core.handle_key("]") and core.thresh_db == -37.0
    assert core.handle_key("[") and core.thresh_db == -40.0
    assert not core.handle_key("q")
    weak_rssi = core.rssi_rows[rows[-1]]
    core.thresh_db = weak_rssi + 3.0
    for c in _chunks(z, SMALL["chunk_in"]):
        core.push(c)
    assert rows[-1] in [r for r, _, _ in core.activity()]
    assert any("active" in ln for ln in core.render_lines())


def _run_live(pkg, tmp_path):
    import importlib
    fk = importlib.import_module(f"{pkg}.io.fake_kiwi")
    mon = importlib.import_module(f"{pkg}.apps.monitor")
    iq = _wideband_iq(FS * 3)
    server = fk.FakeKiwiServer(fk.FakeKiwiConfig(iq_source=iq, n_frames=64,
                                                 audio_rate=FS)).start()
    rec = str(tmp_path / f"{pkg}.wav")
    args = argparse.Namespace(
        input=None, n_chan=N_CHAN, mode="AM", thresh=-40.0, select=1.5,
        record=rec, headless=True, max_chunks=6, print_every=100,
        rate=FS // N_CHAN, frames=64, kiwiserver="127.0.0.1",
        kiwiport=server.port, password="", freq=10000.0)
    if pkg == "supersdr_tpu_torch":
        args.device = "cpu"
    try:
        rc = mon.run_monitor(args)
    finally:
        server.stop()
    return rc, _wav(rec)


def test_monitor_live_against_fake_kiwi(tmp_path, capsys):
    """`run_monitor` headless on the live int16 stream of each package's
    fake KiwiSDR: the same printed table and the selected channel's
    recording (its 200 Hz program tone) ≥ 75 dB from the reference's."""
    rc, a = _run_live("supersdr_tpu_torch", tmp_path)
    port_out = capsys.readouterr().out
    rc_ref, b = _run_live("supersdr_tpu", tmp_path)
    ref_out = capsys.readouterr().out
    assert rc == rc_ref == 0
    assert a.size == b.size > 3000
    assert _snr(b, a) >= WAV_DB
    tail = a[len(a) // 2:]
    sp = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
    f = np.fft.rfftfreq(len(tail), N_CHAN / (4.0 * FS))
    assert abs(f[10 + np.argmax(sp[10:])] - 200.0) < 15.0

    def rows(out):      # "row freq rssi" lines, RSSI to 0.1 dB
        return [ln.split()[:2] for ln in out.splitlines()
                if ln[:1] in " >" and "k " in ln]
    assert rows(port_out) == rows(ref_out) and rows(port_out)


def test_monitor_over_mesh_process():
    """The monitor runs unmodified over the port's sharded pipeline (4
    shards of the CPU): `sharded_wideband.build`'s process fn and its
    `channel_order` plug into MonitorCore; the activity list finds the
    reference's carriers and the RSSI table is the serial monitor's."""
    from supersdr_tpu_torch.parallel import sharded_wideband
    kw = dict(SMALL, chunk_in=3072)
    cfg = twb.WidebandConfig(**kw)
    proc = sharded_wideband.build(cfg, sharded_wideband.make_mesh(
        4, device="cpu"))
    params = twb.make_params(cfg, device="cpu")

    def process_fn(p, st, iq):
        return proc(p, st, iq)
    process_fn.channel_order = proc.channel_order
    core = MonitorCore(cfg, params=params, process_fn=process_fn,
                       thresh_db=-40.0)
    serial = MonitorCore(cfg, params=params, thresh_db=-40.0)
    ref = jmon.MonitorCore(jwb.WidebandConfig(**kw), thresh_db=-40.0)
    for c in _chunks(_wideband_iq(FS), cfg.chunk_in):
        core.push(c)
        serial.push(c)
        ref.push(c)
    assert sorted(round(f) for _, f, _ in core.activity()) == [-3000, 1500]
    _same_activity(core.activity(), ref.activity(), 0.01)
    np.testing.assert_allclose(core.rssi_rows, serial.rssi_rows, atol=1e-4,
                               rtol=0)
