"""The port's terminal panadapter (`apps/tui`) against the JAX package's,
on the CPU.

- `TuiModel`, its render helpers and its key table are the reference's
  source with rewritten imports (held here line for line up to
  `run_tui_wav`); over the port's `Receiver` (on the CPU) one key script
  gives the reference's receiver state and the same rendered lines.
- `run_tui_wav` on the off-air-style fixture WAV: the waterfall history
  the model keeps is the reference's, in the renderer's integer palette
  index (uint8 truncation), equal in ≥ 99.9 % of cells and never more
  than 1 apart (tests/test_torch_spectrum.py's bound on `autolevel`),
  and the receiver has heard the same signal (S-meter within 0.05 dB).
- the reference's own cases of tests/test_tui.py on the port.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest

from supersdr_tpu.apps import tui as jtui
from supersdr_tpu.control import memories as jmem
from supersdr_tpu.control import panadapter as jpan
from supersdr_tpu.control import receiver as jrx
from supersdr_tpu.runtime import chain as jchain
from supersdr_tpu_torch.apps import tui
from supersdr_tpu_torch.control.memories import MemoryBank
from supersdr_tpu_torch.control.panadapter import Panadapter
from supersdr_tpu_torch.control.receiver import Receiver
from supersdr_tpu_torch.runtime import chain

REPO = Path(__file__).resolve().parents[1]
FIXTURE = str(REPO / "tests" / "fixtures" / "kiwi_am_offair_12k.wav")
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)supersdr_tpu(?=[.\s])", re.M)


def make_model(tmp_path, ref=False, width=80):
    kw = dict(mode="USB", chunk=2048, os_block=2048, n_taps=129)
    if ref:
        rx = jrx.Receiver(cfg=jchain.ChainConfig(**kw),
                          center_freq_khz=14200.0, freq=14200.0,
                          radio_mode="USB")
        return jtui.TuiModel(rx=rx, pan=jpan.Panadapter(zoom=8,
                                                        freq_khz=14200.0),
                             width=width, memories=jmem.MemoryBank(
                                 tmp_path / "jm.json"))
    rx = Receiver(cfg=chain.ChainConfig(**kw), center_freq_khz=14200.0,
                  freq=14200.0, radio_mode="USB", device="cpu")
    return tui.TuiModel(rx=rx, pan=Panadapter(zoom=8, freq_khz=14200.0),
                        width=width, memories=MemoryBank(tmp_path / "m.json"))


# the one change above `run_tui_wav`: the reference marks DX spots at
# their ids as if they were frequencies (`DxCluster.get_stations` gives
# spot ids), so no spot lands on the span
DX_FIX = ("""            for f in self.dx.get_stations(pan.start_f_khz, pan.end_f_khz):
                c = self._col(f)
""", """            # DxCluster.get_stations gives spot ids; the mark goes at the
            # spot's frequency
            for sid in self.dx.get_stations(pan.start_f_khz, pan.end_f_khz):
                c = self._col(self.dx.spot(sid)[1])
""")


def _code(src: str) -> str:
    """The statements of a module's source, docstrings and comments
    dropped (`ast.dump`)."""
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_model_is_the_reference_source_line_for_line():
    """Above `run_tui_wav` the port's code is the reference's with its
    imports rewritten and the one named change; the docstrings may be
    worded otherwise."""
    ref = (REPO / "supersdr_tpu" / "apps" / "tui.py").read_text()
    port = (REPO / "supersdr_tpu_torch" / "apps" / "tui.py").read_text()
    cut = "def run_tui_wav("
    want = _IMPORT.sub(r"\1supersdr_tpu_torch", ref[:ref.index(cut)])
    assert want.count(DX_FIX[0]) == 1
    want = want.replace(*DX_FIX)
    assert _code(port[:port.index(cut)]) == _code(want)
    assert port[:port.index(cut)].count("\n") == want.count("\n")


KEYS = ["RIGHT", "<", "c", "a", "k", "j", "j", "v", "v", "b", "m", "UP",
        "UP", "DOWN", "g", "g", "h", "w", "RIGHT", "u", "w", "r", "x",
        ">", "PGUP", "PGDN", ",", ".", ".", ";", "'", "1", "1", "2", "!",
        "@", "@", "3", "4", "E", "o", "f", "7", "0", "7", "4", ".", "5",
        "\r", "0", "W", "1", "A", "W", "\r", "9", "w", "1", "a", "\r",
        ("MOUSE", "press", 30, 9, False), ("MOUSE", "drag", 45, 9, False),
        ("MOUSE", "release", 45, 9, False), ("MOUSE", "wheel_up", 3, 9),
        ("MOUSE", "press", 60, 9, True), ("MOUSE", "drag", 64, 9, True),
        ("MOUSE", "release", 64, 9, True), ("MOUSE", "press", 50, 2, False),
        ("MOUSE", "drag", 40, 2, False), "?"]


def _state(m):
    rx, pan = m.rx, m.pan
    return (rx.freq, rx.radio_mode, rx.lc, rx.hc, rx.volume, rx.muted,
            rx.agc.thresh, rx.agc.decay, pan.zoom, pan.freq_khz,
            m.averaging_n, m.auto_mode, m.recording, m.wf_delta_low_db,
            m.wf_delta_high_db, m.spectrum_fill, m.show_help, m.message,
            len(m.memories))


def test_key_script_renders_like_the_reference(tmp_path, monkeypatch):
    """One key script (tuning, modes, passband, volume, zoom, averaging,
    memories, AGC, clip levels, direct entry, the QSO log, mouse gestures)
    on both models, each fed the same waterfall rows: equal receiver and
    panadapter state after every key, and equal rendered lines."""
    monkeypatch.chdir(tmp_path)
    rows = np.random.default_rng(0).uniform(0, 255, (12, 1024))
    port, ref = make_model(tmp_path), make_model(tmp_path, ref=True)
    from supersdr_tpu.control import logbook as jlog
    from supersdr_tpu_torch.control import logbook as tlog
    port.logbook = tlog.Logbook(tmp_path / "port.sdr")
    ref.logbook = jlog.Logbook(tmp_path / "ref.sdr")
    for m in (port, ref):
        for r in rows:
            m.push_row(r)
    for k in KEYS:
        assert port.handle_key(k) == ref.handle_key(k)
        assert _state(port) == _state(ref), k
        if k in ("UP", "?", "x"):
            assert port.render() == ref.render(), k
    port.show_help = ref.show_help = False
    assert port.render() == ref.render()
    assert not port.handle_key("q")


def test_run_tui_wav_history_matches_the_reference(capsys):
    kw = dict(mode="AM", freq_khz=14200.0, width=96, height=40,
              speed=1e9)
    port = tui.run_tui_wav(FIXTURE, device="cpu", **kw)
    ref = jtui.run_tui_wav(FIXTURE, **kw)
    out = capsys.readouterr().out
    assert out.count("\x1b[2J") >= 2
    assert len(port.history) == len(ref.history) >= 30
    pi = np.stack(port.history).astype(np.uint8).astype(int)
    ji = np.stack([np.asarray(r) for r in ref.history]
                  ).astype(np.uint8).astype(int)
    assert np.mean(pi == ji) >= 0.999
    assert np.abs(pi - ji).max() <= 1
    assert abs(port.rx.smoothed_rssi - ref.rx.smoothed_rssi) < 0.05
    assert port.rx.device.type == "cpu"


# ------------------------------------------- the reference's tui cases

def test_key_table(tmp_path):
    m = make_model(tmp_path)
    assert m.handle_key("RIGHT")
    assert m.rx.freq == 14201.0
    m.handle_key("<")
    assert m.rx.freq == 14191.0
    m.handle_key("c")
    assert m.rx.radio_mode == "CW"
    m.handle_key("a")
    assert m.rx.radio_mode == "AM"
    m.handle_key("k")
    m.handle_key("v")
    assert m.rx.volume == 110
    m.handle_key("m")
    assert m.rx.muted
    m.handle_key("UP")
    assert m.pan.zoom == 9
    m.handle_key("g")
    assert m.averaging_n == 2
    m.handle_key("w")
    m.handle_key("r")
    assert not m.handle_key("q")


def test_memory_recall_restores(tmp_path):
    m = make_model(tmp_path)
    m.handle_key("w")                       # store 14200 USB
    m.handle_key("RIGHT"); m.handle_key("RIGHT")
    m.handle_key("c")
    m.handle_key("w")                       # store 14202 CW
    m.handle_key("r")                       # cyclic recall
    assert (m.rx.freq, m.rx.radio_mode) in ((14200.0, "USB"),
                                            (14202.0, "CW"))


def test_render_rows(tmp_path, rng):
    m = make_model(tmp_path)
    for _ in range(5):
        m.push_row(rng.uniform(0, 255, 1024))
    lines = m.render()
    assert len(lines) == 2 + 1 + 5  # status, span, spectrum, waterfall
    assert "kHz" in lines[0] and "S" in lines[0]
    assert "span" in lines[1]
    assert "\x1b[48;5;" in lines[3]  # ANSI colored waterfall
    assert len(lines[2]) == 80


def test_resample_bins_preserves_peaks():
    row = np.zeros(1024)
    row[500] = 250.0
    r = tui.resample_bins(row, 64)
    assert r.max() == 250.0
    assert len(r) == 64


def test_smeter_text():
    assert "S9" in tui.smeter_text(-73.0)
    assert "S1" in tui.smeter_text(-121.0)
    assert tui.smeter_text(-100.0) == jtui.smeter_text(-100.0)


@pytest.mark.parametrize("on", [True, False])
def test_eibi_and_dx_overlays(tmp_path, on):
    """The `i` and `d` overlays: the reference's EIBI stations and beacons
    (the reference package's EIBI file), and a fed cluster's spot at its
    frequency."""
    from supersdr_tpu_torch.control.dxcluster import DxCluster
    port, ref = make_model(tmp_path), make_model(tmp_path, ref=True)
    for m in (port, ref):
        m.pan.set_freq_zoom(7100.0, 6)
        m.dx = DxCluster("TEST0CALL")
        m.dx.feed("DX de EA5XYZ:     7074.0  W1AW         FT8\n")
        if on:
            m.handle_key("i")
            m.handle_key("d")
        m.push_row(np.full(1024, 100.0))
    if not on:
        assert port.render() == ref.render()
        return
    # EIBI and beacon marks as the reference's; the spot marked at 7074
    # kHz, where the reference puts none
    col = port._col(7074.0)
    got, want = port.overlay_lines(), ref.overlay_lines()
    assert got[1:] == want[1:]
    assert got[0][col] == "x" and "x" not in want[0]
    assert got[0][:col] + got[0][col + 1:] == want[0][:col] + want[0][col + 1:]
