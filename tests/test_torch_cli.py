"""The port's CLI (`python -m supersdr_tpu_torch.cli`) against the JAX
package's (`python -m supersdr_tpu.cli`), on the CPU (`--device cpu`),
each subcommand on the same KiwiSDR IQ WAV.

Tolerances:
- demod audio ≥ 75 dB between the two int16 WAVs: both chains are float32
  and agree to ≥ 80 dB before the int16 rounding (tests/test_torch_chain),
  which then leaves a few codes of difference at most.
- wideband audio ≥ 75 dB likewise, channel for channel through each
  package's own channel order (the files are named by it).
- the waterfall PNG: the same size; the waterfall rows' pixels (a palette
  color per bin) equal in ≥ 99.9 % of pixels and never more than one
  palette step apart, as `autolevel`'s colors (tests/test_torch_spectrum).
  The spectrum trace above them is drawn from the same colors.
- the printed lines: the same words, and each number within 0.1 (they are
  printed to one decimal).
- the live session against each package's own fake KiwiSDR: what
  tests/test_cli_apps.py asserts of the reference's session.
"""

import json
import re
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from supersdr_tpu import cli as jcli
from supersdr_tpu_torch import cli as tcli
from supersdr_tpu_torch.display import colormap
from supersdr_tpu_torch.io import wav

FIXTURE = str(Path(__file__).resolve().parent / "fixtures"
              / "kiwi_am_offair_12k.wav")
AUDIO_DB = 75.0


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


def _noisy(z, seed, level=0.002):
    rng = np.random.default_rng(seed)
    n = len(z)
    return (z + level * (rng.normal(size=n) + 1j * rng.normal(size=n))
            ).astype(np.complex64)


def _am_wav(path, fs=12000, n=512 * 48, seed=0):
    t = np.arange(n) / fs
    z = 0.3 * (1 + 0.6 * np.cos(2 * np.pi * 800 * t)) \
        * np.exp(2j * np.pi * 1500 * t)
    wav.write_kiwi_iq_wav(path, _noisy(z, seed), fs)


def _usb_wav(path, fs, n, seed=1):
    t = np.arange(n) / fs
    wav.write_kiwi_iq_wav(path, _noisy(0.3 * np.exp(2j * np.pi * 1000 * t),
                                       seed), fs)


def _run_both(capsys, tmp_path, argv_of):
    """Run both CLIs; argv_of(out_dir) builds the arguments. Returns
    (ref_dir, port_dir, ref_lines, port_lines)."""
    out = {}
    for name, mod, extra in (("ref", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        capsys.readouterr()
        assert mod.main(argv_of(d) + extra) == 0
        text = capsys.readouterr().out.replace(str(d), "<out>")
        out[name] = (d, text.strip().splitlines())
    return out["ref"][0], out["port"][0], out["ref"][1], out["port"][1]


_NUM = re.compile(r"[-+]?\d+\.\d+|[-+]?\d+")


def _assert_lines_match(ref_lines, port_lines):
    assert len(port_lines) == len(ref_lines), (ref_lines, port_lines)
    for r, p in zip(ref_lines, port_lines):
        assert _NUM.sub("#", r) == _NUM.sub("#", p), (r, p)
        for a, b in zip(_NUM.findall(r), _NUM.findall(p)):
            assert abs(float(a) - float(b)) <= 0.1 + 1e-9, (r, p)


DEMOD_CASES = {
    "am": (lambda p: _am_wav(p), ["--mode", "AM"]),
    "usb-agc-off": (lambda p: _usb_wav(p, 12000, 512 * 40),
                    ["--mode", "USB", "--agc-off"]),
    "usb-20k25": (lambda p: _usb_wav(p, 20250, 512 * 60),
                  ["--mode", "USB", "--passband", "matmul"]),
    "offair-fixture": (None, ["--mode", "AM", "--freq-offset", "0"]),
}


@pytest.mark.parametrize("case", sorted(DEMOD_CASES))
def test_demod_matches_reference(case, tmp_path, capsys):
    make, opts = DEMOD_CASES[case]
    src = FIXTURE
    if make is not None:
        src = str(tmp_path / "in.wav")
        make(src)
    jd, td, jl, tl = _run_both(
        capsys, tmp_path,
        lambda d: ["demod", src, "-o", str(d / "audio.wav")] + opts)
    _assert_lines_match(jl, tl)
    ja, jr = wav.read_audio_wav(jd / "audio.wav")
    ta, tr = wav.read_audio_wav(td / "audio.wav")
    assert jr == tr == 48000 and ta.shape == ja.shape
    assert _snr(ja, ta) >= AUDIO_DB


def _png_rgb(path):
    raw = open(path, "rb").read()
    w, h = np.frombuffer(raw[16:24], ">u4")
    pos, idat = 8, b""
    while pos < len(raw):
        n = int.from_bytes(raw[pos:pos + 4], "big")
        if raw[pos + 4:pos + 8] == b"IDAT":
            idat += raw[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (rows[:, 0] == 0).all()            # filter type 0 on every row
    return rows[:, 1:].reshape(h, w, 3)


def _palette_index(rgb, palette):
    """Palette entry of each pixel (the nearest; the waterfall rows hold
    palette colors exactly)."""
    d = np.abs(rgb[..., None, :].astype(int) - palette[None, None].astype(int))
    return np.argmin(d.sum(-1), axis=-1)


def test_waterfall_matches_reference(tmp_path, capsys):
    src = str(tmp_path / "in.wav")
    _am_wav(src, n=512 * 96)
    jd, td, jl, tl = _run_both(
        capsys, tmp_path,
        lambda d: ["waterfall", src, "-o", str(d / "wf.png"), "--avg", "4"])
    _assert_lines_match(jl, tl)
    jp, tp = _png_rgb(jd / "wf.png"), _png_rgb(td / "wf.png")
    assert jp.shape == tp.shape and jp.shape[1] == 1024
    n_rows = int(re.search(r"(\d+) rows", jl[0]).group(1))
    pal = colormap.get_palette("cutesdr")
    ji = _palette_index(jp[-n_rows:], pal)
    ti = _palette_index(tp[-n_rows:], pal)
    assert np.mean(ji == ti) >= 0.999
    assert np.abs(ji - ti).max() <= 1


# audio bound between the two CLIs' WAVs: the fast tier rounds operands to
# bf16 in both packages at other places (PERF.md §2: ≥ 45 dB)
WIDEBAND_DB = {None: AUDIO_DB, "quality": AUDIO_DB, "fast": 45.0}


def _by_freq(d):
    """{'+36.0kHz': path} of a wideband output directory (files are named
    chan_<row>_<freq>.wav, rows in each package's own channel order)."""
    return {p.stem.split("_")[-1]: p for p in d.glob("*.wav")}


@pytest.mark.parametrize("profile", [None, "fast", "quality"])
def test_wideband_matches_reference(profile, tmp_path, capsys):
    """Channels of a wideband capture: the default (chan-major, plain
    tail) at 8 channels, and both profiles on the planar tier at 512
    channels (the port's channelizer and FIR-tail plain versions against
    the reference's Pallas kernels in interpret mode)."""
    n_chan, frames = (8, 1536) if profile is None else (512, 256)
    fs = n_chan * 12000
    from supersdr_tpu_torch.ops import channelizer
    plan, _ = channelizer.design(n_chan, 8)
    freqs = channelizer.channel_center_freqs(plan, fs)
    n = n_chan * frames + 1024 + 333   # two settling frames, a ragged tail
    t = np.arange(n) / fs
    m = 0.6 * np.cos(2 * np.pi * 500 * t)
    z = 0.4 * (1 + m) * np.exp(2j * np.pi * freqs[3] * t) \
        + 0.2 * np.exp(2j * np.pi * (freqs[n_chan // 2 + 1] + 700) * t)
    src = str(tmp_path / "wide.wav")
    wav.write_kiwi_iq_wav(src, _noisy(z, 5), fs)
    opts = ["--profile", profile] if profile else []
    jd, td, jl, tl = _run_both(
        capsys, tmp_path,
        lambda d: ["wideband", src, "-o", str(d / "ch"), "--n-chan",
                   str(n_chan), "--top", "3"] + opts)
    # the port adds one line: the samples left over after the last chunk
    # (the reader drops the first two frames; chunks of 8-frame multiples)
    nz = n - 1024
    chunk = (min(nz, fs) // (8 * n_chan)) * (8 * n_chan)
    assert tl[-1] == (f"did not process the last {nz % chunk} samples "
                      f"(less than one chunk of {chunk})")
    jw, tw = _by_freq(jd / "ch"), _by_freq(td / "ch")
    assert jw.keys() == tw.keys() and len(jw) == 3
    assert f"{freqs[3] / 1000:+.1f}kHz" in jw
    if profile is None:
        _assert_lines_match(jl, tl[:-1])
    else:
        # rows are in each package's order and the files named by it:
        # the lines compare by frequency
        def by_freq(lines):
            return sorted(re.sub(r"chan_\d+_", "chan_", x) for x in lines)
        _assert_lines_match(by_freq(jl[:-1]), by_freq(tl[:-2]))
        _assert_lines_match(jl[-1:], tl[-2:-1])
    for f, path in jw.items():
        ja, _ = wav.read_audio_wav(path)
        ta, _ = wav.read_audio_wav(tw[f])
        assert _snr(ja, ta) >= WIDEBAND_DB[profile], f


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_live_kiwi_session_records_audio(pkg, tmp_path):
    """Full stack: a fake KiwiSDR serves IQ; the session demodulates it
    and records the audio (each package with its own fake server)."""
    if pkg == "ref":
        from supersdr_tpu.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer
        mod, extra = jcli, []
    else:
        from supersdr_tpu_torch.io.fake_kiwi import (FakeKiwiConfig,
                                                     FakeKiwiServer)
        mod, extra = tcli, ["--device", "cpu"]
    fs = 12000
    t = np.arange(512 * 64) / fs
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    server = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, n_frames=48,
                                           audio_rate_true=12000.0)).start()
    out = tmp_path / "live.wav"
    try:
        rc = mod.main(["kiwi", "-s", "127.0.0.1", "-p", str(server.port),
                       "-f", "14200", "--mode", "USB", "-o", str(out),
                       "--frames", "40", "-b", "4"] + extra)
        assert rc == 0
    finally:
        server.stop()
    data, rate = wav.read_audio_wav(out)
    assert rate == 48000
    assert len(data) > 4 * 2048
    audio = data.astype(np.float64) / 32767.0
    assert tone_snr_db(audio[len(audio) // 2:], 1000.0, rate) > 20


def test_live_session_waterfall_iq_record_and_pipeline(tmp_path):
    """The session with a concurrent W/F stream, IQ recording and two
    chunks in flight (`--pipeline 2`: Receiver.process_dispatch /
    process_fetch), as tests/test_live_waterfall.py runs the reference's.
    The waterfall PNG holds the reference's rendering of the rows the
    session received, by palette index."""
    import jax.numpy as jnp
    from supersdr_tpu.display import render as jrender
    from supersdr_tpu.ops import spectrum as jspec
    from supersdr_tpu_torch.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer
    fs = 12000
    t = np.arange(512 * 48) / fs
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    rows = np.random.default_rng(8).integers(120, 230, (40, 1024),
                                             dtype=np.uint8)
    server = FakeKiwiServer(FakeKiwiConfig(iq_source=iq, wf_source=rows,
                                           n_frames=40,
                                           audio_rate_true=12000.0)).start()
    out, wf_png, iq_wav = (tmp_path / n for n in ("a.wav", "wf.png",
                                                  "iq.wav"))
    try:
        assert tcli.main(["kiwi", "-s", "127.0.0.1", "-p", str(server.port),
                          "-f", "14200", "--mode", "USB", "-o", str(out),
                          "--frames", "32", "-b", "4", "--pipeline", "2",
                          "--waterfall-png", str(wf_png),
                          "--record-iq", str(iq_wav),
                          "--device", "cpu"]) == 0
    finally:
        server.stop()
    got = _png_rgb(wf_png)
    n = got.shape[0] - 150 - 8              # scope, tick bar, then rows
    assert got.shape[1] == 1024 and n > 10
    db = jspec.kiwi_byte_to_db(jnp.asarray(rows[:n][::-1]), 8)
    want = jrender.render_panadapter(
        np.asarray(jspec.autolevel(db).color), palette_name="cutesdr")
    pal = colormap.get_palette("cutesdr")
    gi, wi = _palette_index(got[-n:], pal), _palette_index(want[-n:], pal)
    assert np.mean(gi == wi) >= 0.999 and np.abs(gi - wi).max() <= 1
    t2, z2 = wav.read_kiwi_iq_wav(iq_wav)
    assert len(z2) > 512 * 20
    ref = iq[1024: 1024 + len(z2)]
    corr = np.abs(np.vdot(z2, ref)) / (np.linalg.norm(z2)
                                       * np.linalg.norm(ref) + 1e-12)
    assert corr > 0.99
    data, rate = wav.read_audio_wav(out)
    assert rate == 48000 and len(data) > 4 * 2048
    audio = data.astype(np.float64) / 32767.0
    assert tone_snr_db(audio[len(audio) // 2:], 1000.0, rate) > 20


def test_live_kiwi_session_at_20k25(tmp_path):
    """A 20.25 kHz KiwiSDR: the session's chain takes the rational
    resampler (chunk 2025)."""
    from supersdr_tpu_torch.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer
    fs = 20250
    t = np.arange(512 * 64) / fs
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
    server = FakeKiwiServer(FakeKiwiConfig(
        iq_source=iq, n_frames=48, audio_rate=fs,
        audio_rate_true=float(fs))).start()
    out = tmp_path / "live.wav"
    try:
        assert tcli.main(["kiwi", "-s", "127.0.0.1", "-p", str(server.port),
                          "-f", "14200", "--mode", "USB", "-o", str(out),
                          "--frames", "40", "-b", "4",
                          "--device", "cpu"]) == 0
    finally:
        server.stop()
    data, rate = wav.read_audio_wav(out)
    assert rate == 48000 and len(data) > 4 * 2025 * 48000 // fs
    audio = data.astype(np.float64) / 32767.0
    assert tone_snr_db(audio[len(audio) // 2:], 1000.0, rate) > 20


@pytest.mark.parametrize("argv", [
    ["demod", "x.wav"], ["waterfall", "x.wav"], ["wideband", "x.wav"],
    ["kiwi", "-s", "127.0.0.1"], ["kiwi", "-s", "127.0.0.1", "--tui"],
    ["tui", "x.wav"], ["monitor", "x.wav"], ["monitor"], ["bench"]])
def test_cli_raises_without_a_card(argv, monkeypatch):
    """With no card and no --device the CLI raises before any work (the
    input file does not exist: nothing is read)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        tcli.main(argv)


def test_bench_reaches_the_benchmark_with_the_device(monkeypatch, capsys):
    """`cli bench --device cpu` runs `bench.main` on that device: the
    measurement (stubbed here) gets the CPU and the headline shape, and
    the printed line carries the device."""
    from supersdr_tpu_torch import bench
    seen = []

    def fake_measure(tuning, device, headline, refs):
        seen.append((device, headline))
        return {"value": 1.0, "integrity": "pass"}
    monkeypatch.setattr(bench, "measure", fake_measure)
    assert tcli.main(["bench", "--device", "cpu"]) == 0
    assert seen == [(torch.device("cpu"), bench.HEADLINE)] * 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == {"name": "cpu", "power_limit": None}
    assert line["quality"]["value"] == 1.0


_SGR = re.compile(r"\x1b\[48;5;(\d+)m")


def _ansi_cells(line):
    """A waterfall row as rendered (a background colour escape before each
    run of equal cells) → the xterm palette index of each cell."""
    cells, idx = [], None
    for part in re.split(r"(\x1b\[[0-9;]*m)", line):
        m = _SGR.fullmatch(part)
        if m:
            idx = int(m.group(1))
        elif not part.startswith("\x1b"):
            cells += [idx] * len(part)
    return cells


def _last_frame(text):
    return text.split("\x1b[2J\x1b[H")[-1].splitlines()


def test_tui_matches_reference(capsys):
    """`tui` on the off-air-style fixture: the end frame's status and span
    lines equal, the spectrum trace and waterfall rows equal in ≥ 99 % of
    their cells (the ANSI ramp over `autolevel` colours equal in ≥ 99.9 %
    of cells, tests/test_torch_spectrum.py)."""
    argv = ["tui", FIXTURE, "--mode", "AM", "-f", "14200", "-W", "96",
            "-H", "40", "--speed", "1e9"]
    frames = {}
    for name, mod, extra in (("ref", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        capsys.readouterr()
        assert mod.main(argv + extra) == 0
        frames[name] = _last_frame(capsys.readouterr().out)
    ref, port = frames["ref"], frames["port"]
    assert len(port) == len(ref) > 30
    assert port[:2] == ref[:2]
    same = np.mean([a == b for a, b in zip(port[2], ref[2])])
    assert same >= 0.99, (port[2], ref[2])
    pc = np.array([_ansi_cells(ln) for ln in port[3:]])
    rc = np.array([_ansi_cells(ln) for ln in ref[3:]])
    assert pc.shape == rc.shape and pc.shape[1] == 96
    assert np.mean(pc == rc) >= 0.99


def test_monitor_matches_reference(tmp_path, capsys):
    """`monitor --headless` on a 12 kHz capture with two AM carriers cut
    into 8 channels: the same activity tables (rows, frequencies, RSSI to
    0.1 dB) and the selected channel's recording ≥ 75 dB."""
    fs, n = 12_000, 12_000 * 2 + 1024
    t = np.arange(n) / fs
    z = 0.35 * (1 + 0.6 * np.sin(2 * np.pi * 200 * t)) \
        * np.exp(2j * np.pi * 1500 * t) \
        + 0.18 * (1 + 0.6 * np.sin(2 * np.pi * 350 * t)) \
        * np.exp(-2j * np.pi * 3000 * t)
    src = str(tmp_path / "wide.wav")
    wav.write_kiwi_iq_wav(src, _noisy(z, 3), fs)
    jd, td, jl, tl = _run_both(
        capsys, tmp_path,
        lambda d: ["monitor", src, "--n-chan", "8", "--thresh", "-40",
                   "--select", "1.5", "--record", str(d / "sel.wav"),
                   "--headless", "--print-every", "2"])
    _assert_lines_match(jl, tl)
    assert any(ln.startswith(">") and "+1.5k" in ln for ln in tl)
    ja, jr = wav.read_audio_wav(jd / "sel.wav")
    ta, tr = wav.read_audio_wav(td / "sel.wav")
    assert jr == tr == 6000 and ta.shape == ja.shape and ta.size >= 8000
    assert _snr(ja, ta) >= AUDIO_DB


class _Tty:
    """A terminal on stdin, so `kiwi --tui` reads its keys from
    `stdin_keys` (replaced by a key script here)."""

    def isatty(self):
        return True


def test_kiwi_tui_matches_reference(tmp_path, monkeypatch):
    """`kiwi --tui` against each package's fake KiwiSDR with the same keys
    (SUB on, SUB to the span centre, AM, a retune, SUB off): the recorded
    stereo WAVs ≥ 75 dB apart, and the last frame's status line the
    same."""
    import importlib
    import sys
    monkeypatch.setattr(sys, "stdin", _Tty())
    t = np.arange(512 * 64) / 12000
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)
          + 0.1 * np.exp(2j * np.pi * 2500 * t)).astype(np.complex64)
    got = {}
    for pkg, mod, extra in (("supersdr_tpu", jcli, []),
                            ("supersdr_tpu_torch", tcli,
                             ["--device", "cpu"])):
        fk = importlib.import_module(f"{pkg}.io.fake_kiwi")
        lt = importlib.import_module(f"{pkg}.apps.live_tui")
        server = fk.FakeKiwiServer(fk.FakeKiwiConfig(
            iq_source=iq, n_frames=48, audio_rate_true=12000.0)).start()
        out = tmp_path / f"{pkg}.wav"
        frames, orig = [], lt.ansi_render
        lt.ansi_render = frames.append
        keys = iter([[], ["y"], [], ["n"], ["a"], [], ["RIGHT"], [], ["Y"]])
        orig_keys = lt.stdin_keys
        lt.stdin_keys = lambda *a, **k: (lambda: next(keys, []))
        try:
            assert mod.main(["kiwi", "-s", "127.0.0.1", "-p",
                             str(server.port), "-f", "14200", "--mode",
                             "USB", "-o", str(out), "--frames", "40",
                             "--tui", *extra]) == 0
        finally:
            lt.ansi_render, lt.stdin_keys = orig, orig_keys
            server.stop()
        got[pkg] = (wav.read_audio_wav(out), frames)
    (a, ra), fa = got["supersdr_tpu_torch"]
    (b, rb), fb = got["supersdr_tpu"]
    assert ra == rb == 48000 and a.shape[1] == b.shape[1] == 2
    n = min(len(a), len(b))
    assert n >= 8 * 2048 and abs(len(a) - len(b)) <= 4 * 2048
    assert _snr(b[:n], a[:n]) >= AUDIO_DB
    assert fa and fb
    assert _NUM.sub("#", fa[-1][0]) == _NUM.sub("#", fb[-1][0])
    # the keys reached the session: the SUB line came and went, AM was
    # selected, the retune moved MAIN (and the band plan set USB again)
    assert any(f[1].startswith(" SUB") for f in fa)
    assert any(" AM " in f[0] for f in fa)
    assert not fa[-1][1].startswith(" SUB") and "14201.00" in fa[-1][0]
