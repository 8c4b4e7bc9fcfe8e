"""The port's live interactive session (`apps/live_tui`, `kiwi --tui`)
against the JAX package's, on the CPU.

- `LiveTui` on the same IQ chunks and the same keys as the reference's
  (SUB on, MAIN/SUB switch, SUB to the span centre, a mode change, a
  retune, balance, SUB off): equal receiver state after every key; each
  chunk's stereo audio ≥ 80 dB from the reference's (both chains are
  float32 with the AGC off: tests/test_torch_dualrx.py's bound); the
  native waterfall's history in the renderer's palette index equal in
  ≥ 99.9 % of cells and never more than 1 apart
  (tests/test_torch_spectrum.py's bound on `autolevel`).
- SUB add/drop, the switch, a mode change and a retune keep one set of
  device buffers (every leaf of the dual RX's parameters keeps its
  storage), the port's counterpart of the reference's single jit
  signature.
- `kiwi --tui` against each package's fake KiwiSDR with the same keys:
  the recorded stereo WAVs ≥ 75 dB apart over their common length (int16
  rounding; tests/test_torch_cli.py's bound); the sink's pump thread may
  stop a frame short, so the lengths may differ by one chunk.
- the reference's own cases of tests/test_live_tui.py on the port.
"""

import os

import numpy as np
import pytest

from supersdr_tpu.apps import live_tui as jlt
from supersdr_tpu.control import panadapter as jpan
from supersdr_tpu.control import receiver as jrx
from supersdr_tpu.runtime import chain as jchain
from supersdr_tpu_torch.apps import live_tui as lt
from supersdr_tpu_torch.apps.live_tui import LiveTui
from supersdr_tpu_torch.control.panadapter import Panadapter
from supersdr_tpu_torch.control.receiver import Receiver
from supersdr_tpu_torch.runtime import chain

FS = 12000
AUDIO_DB = 80.0
WAV_DB = 75.0


def make_session(freq=14200.0, mode="USB", chunk=2048, ref=False):
    kw = dict(mode=mode, iq_rate=FS, audio_rate=48000, chunk=chunk,
              os_block=chunk)
    if ref:
        rx = jrx.Receiver(cfg=jchain.ChainConfig(**kw),
                          center_freq_khz=freq, freq=freq, radio_mode=mode)
        rx.set_agc_params(on=False)
        return jlt.LiveTui.create(rx, jpan.Panadapter(zoom=10,
                                                      freq_khz=freq),
                                  width=80, wf_height=8)
    rx = Receiver(cfg=chain.ChainConfig(**kw), center_freq_khz=freq,
                  freq=freq, radio_mode=mode, device="cpu")
    rx.set_agc_params(on=False)
    return LiveTui.create(rx, Panadapter(zoom=10, freq_khz=freq), width=80,
                          wf_height=8)


def tone_iq(freq_offset_hz, n, amp=0.3):
    t = np.arange(n) / FS
    return (amp * np.exp(2j * np.pi * freq_offset_hz * t)).astype(np.complex64)


def tone_snr_db(x, freq, fs):
    n = len(x)
    t = np.arange(n) / fs
    basis = np.stack([np.cos(2 * np.pi * freq * t),
                      np.sin(2 * np.pi * freq * t), np.ones(n)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, x, rcond=None)
    fit = basis @ coef
    return 10 * np.log10(np.mean((fit - fit.mean()) ** 2)
                         / max(np.mean((x - fit) ** 2), 1e-30))


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-30))


def _palette(rows):
    return np.stack([np.asarray(r) for r in rows]).astype(np.uint8
                                                          ).astype(int)


def _state(s):
    sub = s.rx_sub
    return (s.rx.freq, s.rx.radio_mode, s.rx.lc, s.rx.hc,
            s.rx.audio_balance, s.main_is_sub, s.pan.freq_khz, s.pan.zoom,
            None if sub is None else (sub.freq, sub.radio_mode, sub.lc,
                                      sub.hc, sub.audio_balance),
            s.model.message)


# keys before each chunk; the SUB's AGC is switched off as it comes up
SCRIPT = [[], ["y"], [], ["5", "5"], ["y"], [], ["n"], ["a"], [],
          ["LEFT", "LEFT"], [], ["6"], ["Y"], [], ["x", "l"], []]


def test_session_matches_the_reference():
    port, ref = make_session(), make_session(ref=True)
    n = 2048
    # RSSI well below the TX-mute level (-20 dB), where a hundredth of a
    # dB would decide whether 15 chunks are muted
    # over a noise floor: bins of FFT rounding noise alone would take any
    # autolevel colour (tests/test_torch_spectrum.py)
    rng = np.random.default_rng(1)
    sig = tone_iq(1000, len(SCRIPT) * n, 0.05) \
        + tone_iq(5000 + 700, len(SCRIPT) * n, 0.05) \
        + (1e-3 * (rng.normal(size=len(SCRIPT) * n)
                   + 1j * rng.normal(size=len(SCRIPT) * n))
           ).astype(np.complex64)
    for s in (port, ref):
        s.pan.set_freq_zoom(14205.0, s.pan.zoom)
    for i, keys in enumerate(SCRIPT):
        for s in (port, ref):
            for k in keys:
                assert s.handle_key(k)
            if s.rx_sub is not None:
                s.rx_sub.set_agc_params(on=False)
        assert _state(port) == _state(ref), (i, keys)
        blk = sig[i * n:(i + 1) * n]
        a, b = port.step(blk), ref.step(blk)
        assert a.shape == b.shape == (4 * n, 2) and a.dtype == np.float32
        assert np.abs(b).max() > 1e-2        # every chunk hears a station
        snr = _snr(b, a)
        assert snr >= AUDIO_DB, (i, keys, snr, port.rx.rssi)
        assert abs(port.rx.rssi - ref.rx.rssi) < 0.01
        assert port.rx.rssi < -25.0 and port.rx.mute_counter == 0
    assert port.rx_sub is None and ref.rx_sub is None
    pi, ji = _palette(port.model.history), _palette(ref.model.history)
    assert pi.shape == ji.shape == (8, 1024)
    assert np.mean(pi == ji) >= 0.999 and np.abs(pi - ji).max() <= 1
    assert port.render_lines()[:2] == ref.render_lines()[:2]


def test_dual_rx_keeps_one_set_of_device_buffers():
    """SUB add, the MAIN/SUB switch, a mode change, a retune and SUB off
    write into the same parameter tensors: no leaf is reallocated."""
    s = make_session()
    n = 2048
    sig = tone_iq(1000, 8 * n, 0.3)
    s.step(sig[:n])
    dual = s._dual

    def ptrs():
        out = []

        def walk(v):
            if v is None:
                return
            if isinstance(v, tuple):
                for x in v:
                    walk(x)
            else:
                out.append((v.data_ptr(), tuple(v.shape), v.dtype))
        walk(dual.params)
        return out
    before = ptrs()
    for i, key in enumerate(["y", "y", "a", "RIGHT", "Y"], start=1):
        s.handle_key(key)
        if s.rx_sub is not None:
            s.rx_sub.set_agc_params(on=False)
        s.step(sig[i * n:(i + 1) * n])
        assert s._dual is dual and ptrs() == before, key
    assert dual.device.type == "cpu" and s._win.device.type == "cpu"


def test_sub_follows_the_main_receivers_device():
    s = make_session()
    s.handle_key("y")
    assert s.rx_sub.device == s.rx.device


def test_wf_row_to_color_is_the_reference():
    rng = np.random.default_rng(0)
    for zoom, lo, hi in ((0, 0.0, 0.0), (8, -3.0, 5.0), (14, 2.0, -1.0)):
        row = rng.integers(0, 256, 1024).astype(np.uint8)
        np.testing.assert_array_equal(
            lt.wf_row_to_color(row, zoom, lo, hi),
            jlt.wf_row_to_color(row, zoom, lo, hi))


SEQUENCES = ["[A", "[B", "[C", "[D", "[5~", "[6~", "[<0;41;7M", "[<64;10;2M",
             "[<65;10;2M", "[<0;41;7m", "[<32;12;7M", "[<4;12;7M",
             "[<36;13;7M", "[Z", "OA", "[<2;5;5M", "[<64;3;3m", "[<x;1;1M"]


def test_parse_escape_sequences():
    assert lt.parse_escape("[A") == "UP"
    assert lt.parse_escape("[5~") == "PGUP"
    assert lt.parse_escape("[<0;41;7M") == ("MOUSE", "press", 40, 6, False)
    assert lt.parse_escape("[<64;10;2M") == ("MOUSE", "wheel_up", 9, 1,
                                             False)
    assert lt.parse_escape("[<0;41;7m") == ("MOUSE", "release", 40, 6,
                                            False)
    assert lt.parse_escape("[<32;12;7M") == ("MOUSE", "drag", 11, 6, False)
    assert lt.parse_escape("[<36;13;7M") == ("MOUSE", "drag", 12, 6, True)
    assert lt.parse_escape("[Z") is None
    assert lt.parse_escape("OA") is None
    assert [lt.parse_escape(q) for q in SEQUENCES] == \
        [jlt.parse_escape(q) for q in SEQUENCES]


def test_keys_drive_tune_mode_zoom():
    s = make_session()
    frames = []
    key_script = iter([["x"], ["RIGHT"], ["RIGHT"], ["l"], ["UP"], [">"],
                       ["q"]])
    src = (tone_iq(1000, 2048) for _ in range(10))
    s.run(src, keys=lambda: next(key_script, []), render=frames.append,
          fps=1000.0)
    assert s.rx.freq == pytest.approx(14200.0 + 1 + 1 + 10)
    assert s.rx.radio_mode == "LSB"
    assert s.pan.zoom == 11
    assert frames and any("LSB" in ln for ln in frames[-1])
    assert len(s.model.history) > 0


def test_dual_rx_mix_and_balance():
    """SUB RX demodulates a second station; balance separates them in the
    stereo mix."""
    s = make_session(freq=14200.0)
    s.handle_key("5")
    s.handle_key("5")
    assert s.rx.audio_balance == -1.0
    s.pan.set_freq_zoom(14205.0, s.pan.zoom)
    s.handle_key("y")
    assert s.rx_sub.freq == pytest.approx(s.pan.freq_khz)
    s.rx_sub.set_agc_params(on=False)
    s.rx_sub.audio_balance = 1.0
    n = 2048
    sig = tone_iq(1000, 8 * n, 0.3) + tone_iq(5000 + 700, 8 * n, 0.3)
    out = np.concatenate([s.step(sig[i * n:(i + 1) * n])
                          for i in range(8)][4:], axis=0)
    assert tone_snr_db(out[:, 0], 1000.0, 48000) > 15
    assert tone_snr_db(out[:, 1], 700.0, 48000) > 15


def test_freq_entry_and_recording_and_clip_keys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    s = make_session()
    for k in ["f", "7", "0", "7", "4", ".", "5", "\r"]:
        assert s.handle_key(k)
    assert s.rx.freq == pytest.approx(7074.5)
    assert s.rx.radio_mode == "LSB"
    s.handle_key("f"); s.handle_key("1"); s.handle_key("ESC")
    assert s.model.freq_entry is None
    s.handle_key("E")
    sig = tone_iq(1000, 4096)
    s.step(sig[:2048]); s.step(sig[2048:])
    s.handle_key("E")
    s.step(sig[:2048])          # triggers save
    wavs = [f for f in os.listdir(tmp_path) if f.endswith(".wav")]
    assert len(wavs) == 1
    from supersdr_tpu_torch.io import wav as wav_io
    data, rate = wav_io.read_audio_wav(tmp_path / wavs[0])
    assert rate == 48000 and data.shape[1] == 2 and len(data) == 2 * 8192
    s.handle_key(".")
    s.handle_key(".")
    assert s.model.wf_delta_high_db == 2.0
    s.handle_key(";")
    assert s.model.wf_delta_low_db == -1.0
    s.handle_key("w")
    s.handle_key("W")
    assert os.path.exists(s.model.memories.path)


def test_mouse_drag_gestures():
    s = make_session()
    m = s.model
    for _ in range(10):
        m.push_row(np.full(100, 128.0))
    s.render_lines()
    spec_row, wf_row = m._spectrum_row, m._wf_row0
    m.handle_key(("MOUSE", "press", 40, wf_row + 2, False))
    f0 = s.rx.freq
    m.handle_key(("MOUSE", "drag", 60, wf_row + 2, False))
    assert s.rx.freq > f0
    assert abs(s.rx.freq - m._col_to_khz(60)) < 1e-6
    m.handle_key(("MOUSE", "release", 60, wf_row + 2, False))
    assert m.drag is None
    center0 = s.pan.freq_khz
    m.handle_key(("MOUSE", "press", 50, spec_row, False))
    m.handle_key(("MOUSE", "drag", 30, spec_row, False))
    assert s.pan.freq_khz > center0
    m.handle_key(("MOUSE", "release", 30, spec_row, False))
    hc0 = s.rx.hc
    col_hi = m._col(s.rx.freq + s.rx.hc / 1000.0)
    m.handle_key(("MOUSE", "press", col_hi, wf_row + 1, True))
    assert m.drag is not None and m.drag[0] == "pb"
    m.handle_key(("MOUSE", "drag", col_hi + 3, wf_row + 1, True))
    assert s.rx.hc > hc0
    m.handle_key(("MOUSE", "drag", col_hi - 2, wf_row + 1, True))
    assert s.rx.hc < hc0 + 3 * 100 + 1
    m.handle_key(("MOUSE", "release", col_hi, wf_row + 1, True))


def test_mouse_click_outside_surface_ignored():
    s = make_session()
    m = s.model
    for _ in range(6):
        m.push_row(np.full(100, 90.0))
    s.render_lines()
    f0 = s.rx.freq
    m.handle_key(("MOUSE", "press", 10, 0, False))
    m.handle_key(("MOUSE", "press", 10, 1, False))
    m.handle_key(("MOUSE", "press", 200, m._wf_row0, False))
    assert s.rx.freq == f0
    z0 = s.pan.zoom
    m.handle_key(("MOUSE", "wheel_up", 10, 0, False))
    assert s.pan.zoom == z0


def test_server_menu_renders_book(tmp_path):
    from supersdr_tpu_torch.control.kiwilist import KiwiList
    s = make_session()
    book = tmp_path / "kiwi.list"
    book.write_text("KIWIHOST;KIWIPORT;KIWIPASSWORD;COMMENTS\n"
                    "kiwi1.example;8073;;alpha\nkiwi2.example;8074;;beta\n")
    s.server_book = KiwiList(book)
    calls = []
    s.switch_server = lambda e: (calls.append(e) or (True, "ok"))
    s.handle_key("K")
    assert s.server_menu
    lines = s.render_lines()
    assert any("kiwi1.example:8073" in ln for ln in lines)
    assert any("beta" in ln for ln in lines)
    s.handle_key("2")
    assert not s.server_menu and calls and calls[0][0] == "kiwi2.example"
    s.handle_key("K")
    s.handle_key("ESC")
    assert not s.server_menu and len(calls) == 1


# ------------------------------------------------------------ kiwi --tui

def _kiwi_tui(pkg, tmp_path, iq, keys, frames=40, extra=(), **server_kw):
    """`kiwi --tui` of one package against its own fake KiwiSDR; returns
    (rc, rendered frames, the recorded WAV's path, the server)."""
    import importlib
    cli = importlib.import_module(f"{pkg}.cli")
    fk = importlib.import_module(f"{pkg}.io.fake_kiwi")
    mod_lt = importlib.import_module(f"{pkg}.apps.live_tui")
    ks = importlib.import_module(f"{pkg}.apps.kiwi_session")
    server = fk.FakeKiwiServer(fk.FakeKiwiConfig(
        iq_source=iq, audio_rate_true=12000.0,
        **{"n_frames": frames + 8, **server_kw})).start()
    out = tmp_path / f"{pkg}.wav"
    rendered, orig = [], mod_lt.ansi_render
    mod_lt.ansi_render = rendered.append
    script = iter(keys)
    try:
        args = cli.build_parser().parse_args(
            ["kiwi", "-s", "127.0.0.1", "-p", str(server.port), "-f",
             "14200", "--mode", "USB", "-o", str(out), "--frames",
             str(frames), "--tui", *extra])
        args.inject_keys = lambda: next(script, [])
        rc = ks.run_kiwi_tui(args)
    finally:
        mod_lt.ansi_render = orig
        server.stop()
    return rc, rendered, out, server


def test_kiwi_tui_against_the_reference(tmp_path):
    """Both packages' `kiwi --tui` on the same served IQ and keys (SUB on,
    SUB to centre, a mode change, a retune, SUB off): the recorded stereo
    audio agrees."""
    from supersdr_tpu_torch.io import wav
    t = np.arange(512 * 64) / FS
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)
          + 0.1 * np.exp(2j * np.pi * 2500 * t)).astype(np.complex64)
    keys = [[], ["y"], [], ["n"], ["a"], [], ["RIGHT"], [], ["Y"]]
    rc_p, frames_p, wav_p, _ = _kiwi_tui("supersdr_tpu_torch", tmp_path,
                                         iq, keys, extra=["--device", "cpu"])
    rc_r, frames_r, wav_r, _ = _kiwi_tui("supersdr_tpu", tmp_path, iq, keys)
    assert rc_p == rc_r == 0 and frames_p and frames_r
    a, ra = wav.read_audio_wav(wav_p)
    b, rb = wav.read_audio_wav(wav_r)
    assert ra == rb == 48000 and a.shape[1] == b.shape[1] == 2
    n = min(len(a), len(b))
    assert n >= 8 * 2048 and abs(len(a) - len(b)) <= 4 * 2048
    assert _snr(b[:n], a[:n]) >= WAV_DB
    assert frames_p[-1][0].split("S")[0] == frames_r[-1][0].split("S")[0]


def test_kiwi_tui_against_fake_server(tmp_path):
    from supersdr_tpu_torch.io import wav
    t = np.arange(512 * 64) / FS
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    rc, rendered, out, _ = _kiwi_tui(
        "supersdr_tpu_torch", tmp_path, iq, [["RIGHT"], ["a"], ["LEFT"]],
        extra=["--device", "cpu"])
    assert rc == 0 and rendered
    data, rate = wav.read_audio_wav(out)
    assert rate == 48000 and len(data) > 2048


def test_kiwi_tui_uses_server_waterfall(tmp_path):
    t = np.arange(512 * 80) / FS
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    rows = np.tile((np.linspace(0, 255, 1024)).astype(np.uint8), (64, 1))
    rc, rendered, _, server = _kiwi_tui(
        "supersdr_tpu_torch", tmp_path, iq, [["UP"]], frames=56,
        extra=["--device", "cpu"], wf_source=rows)
    assert rc == 0 and rendered
    zooms = [c for c in server.commands if "zoom=" in c]
    assert any("zoom=9" in z for z in zooms), zooms[-3:]


def test_interactive_server_switch_and_revert(tmp_path):
    """`K` opens the server book; a busy server is refused and the live
    one keeps playing; a good one takes over the stream."""
    from supersdr_tpu_torch import cli
    from supersdr_tpu_torch.apps import kiwi_session as ks_mod
    from supersdr_tpu_torch.io import wav as wav_io
    from supersdr_tpu_torch.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer
    t = np.arange(512 * 200) / FS
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    srv_a = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, n_frames=80,
                                          audio_rate_true=12000.0)).start()
    srv_b = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, n_frames=80,
                                          audio_rate_true=12000.0)).start()
    srv_busy = FakeKiwiServer(FakeKiwiConfig(iq_source=iq,
                                             too_busy=True)).start()
    book = tmp_path / "kiwi.list"
    book.write_text("KIWIHOST;KIWIPORT;KIWIPASSWORD;COMMENTS\n"
                    f"127.0.0.1;{srv_busy.port};;busy one\n"
                    f"127.0.0.1;{srv_b.port};;good one\n")
    key_script = iter([[], ["K"], ["1"], [], [], ["K"], ["2"], [], []])
    messages, box = [], {}
    orig_render, orig_create = lt.ansi_render, LiveTui.create

    def create_spy(*a, **kw):
        box["s"] = orig_create(*a, **kw)
        return box["s"]

    def keys():
        ks = next(key_script, [])
        if "s" in box:
            messages.append(box["s"].model.message)
        return ks
    lt.ansi_render = lambda lines: None
    LiveTui.create = create_spy
    try:
        args = cli.build_parser().parse_args(
            ["kiwi", "-s", "127.0.0.1", "-p", str(srv_a.port), "-f",
             "14200", "--mode", "USB", "-o", str(tmp_path / "sw.wav"),
             "--frames", "60", "--tui", "--device", "cpu"])
        args.kiwi_list = str(book)
        args.inject_keys = keys
        assert ks_mod.run_kiwi_tui(args) == 0
    finally:
        lt.ansi_render = orig_render
        LiveTui.create = orig_create
        for s in (srv_a, srv_b, srv_busy):
            s.stop()
    joined = "\n".join(messages)
    assert "staying" in joined or "refused" in joined, messages
    assert f"switched to 127.0.0.1:{srv_b.port}" in joined, messages
    assert box["s"].rx.device.type == "cpu"
    data, rate = wav_io.read_audio_wav(tmp_path / "sw.wav")
    assert rate == 48000 and len(data) > 4096
    assert any("SET" in c for c in srv_b.commands)
