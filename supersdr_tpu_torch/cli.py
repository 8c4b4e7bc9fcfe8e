"""supersdr-tpu-torch command line: the JAX package's CLI on the port.

The same subcommands, arguments, outputs and printed lines as
`python -m supersdr_tpu.cli` (the reference's option surface: -s/-p/-w
server, -z zoom, -f freq, -b buffer, -c callsign, -m colormap, plus -S/-P
for the rigctld CAT radio):

  demod      recorded KiwiSDR IQ WAV → demodulated audio WAV
  waterfall  recorded IQ WAV → spectrum/waterfall PNG with auto-leveling
             and LINRAD-style averaging
  wideband   wideband IQ WAV → polyphase channelizer → per-channel audio
  kiwi       live KiwiSDR client: stream audio to a WAV/sound device,
             optional rigctld emulation for fldigi/wsjtx

plus `--device`: the computing subcommands run on the current CUDA device
unless given another (`--device cpu` runs the plain versions on the CPU);
with no card and no `--device` they raise. `tui`, `monitor`, `kiwi --tui`
and `bench` are not ported yet and raise `NotImplementedError` naming
their ROADMAP items. `wideband` also prints how many trailing samples
(less than one chunk) it did not process.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from supersdr_tpu_torch.device import default_device


def _add_common_kiwi(p: argparse.ArgumentParser) -> None:
    p.add_argument("-s", "--kiwiserver", default="kiwisdr.local")
    p.add_argument("-p", "--kiwiport", type=int, default=8073)
    p.add_argument("-w", "--password", default="")
    p.add_argument("-S", "--radioserver", default=None,
                   help="hamlib rigctld host for CAT sync")
    p.add_argument("-P", "--radioport", type=int, default=4532)
    p.add_argument("-z", "--zoom", type=int, default=8)
    p.add_argument("-f", "--freq", type=float, default=14200.0,
                   help="frequency in kHz")
    p.add_argument("-b", "--buffer", type=int, default=10,
                   help="audio buffer depth in frames")
    p.add_argument("-c", "--callsign", default="",
                   help="DX cluster callsign")
    p.add_argument("-m", "--colormap", default="cutesdr")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the current "
                        "CUDA device; 'cpu' runs the plain versions)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="supersdr-tpu-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demod", help="demodulate a recorded IQ WAV")
    d.add_argument("input")
    d.add_argument("-o", "--output", default="audio.wav")
    d.add_argument("--mode", default="AM",
                   choices=["AM", "USB", "LSB", "CW", "NBFM", "IQ"])
    d.add_argument("--low-cut", type=int, default=None)
    d.add_argument("--high-cut", type=int, default=None)
    d.add_argument("--freq-offset", type=float, default=0.0,
                   help="receiver offset inside the capture, Hz")
    d.add_argument("--agc-off", action="store_true")
    d.add_argument("--agc-decay", type=int, default=4000)
    d.add_argument("--agc-thresh", type=int, default=-80)
    d.add_argument("--passband", default="fft", choices=("fft", "matmul"),
                   help="passband filter implementation (see wideband)")
    _add_device(d)

    w = sub.add_parser("waterfall", help="render a waterfall PNG")
    w.add_argument("input")
    w.add_argument("-o", "--output", default="waterfall.png")
    w.add_argument("--nfft", type=int, default=1024)
    w.add_argument("--avg", type=int, default=1,
                   help="LINRAD-style time binning factor (1-100)")
    w.add_argument("-m", "--colormap", default="cutesdr")
    w.add_argument("-f", "--freq", type=float, default=None,
                   help="capture center in kHz: enables EIBI/beacon "
                        "station markers on the span")
    w.add_argument("--no-eibi", action="store_true",
                   help="suppress station markers even when --freq given")
    _add_device(w)

    wb = sub.add_parser("wideband", help="channelize a wideband capture")
    wb.add_argument("input")
    wb.add_argument("-o", "--outdir", default="channels")
    wb.add_argument("--n-chan", type=int, default=100)
    wb.add_argument("--mode", default="AM")
    wb.add_argument("--top", type=int, default=8,
                    help="write audio for the N strongest channels")
    wb.add_argument("--profile", default=None, choices=("fast", "quality"),
                    help="kernel tuning profile (runtime.wideband"
                         ".PROFILES): 'fast' = the fused channelizer and "
                         "FIR-tail kernels with bf16 operands, 'quality' "
                         "= the same kernels in float32 (three bf16 "
                         "passes). Overrides --passband. Default: the "
                         "full-precision chan-major path")
    wb.add_argument("--passband", default="fft",
                    choices=("fft", "fftmxu", "matmul"),
                    help="passband filter: overlap-save FFT or the "
                         "Toeplitz matmul (ops/fir_matmul.py)")
    _add_device(wb)

    k = sub.add_parser("kiwi", help="stream audio from a live KiwiSDR")
    _add_common_kiwi(k)
    k.add_argument("--mode", default=None,
                   help="override auto band-plan mode")
    k.add_argument("-o", "--output", default=None,
                   help="record audio to WAV instead of the sound device")
    k.add_argument("--frames", type=int, default=0,
                   help="stop after N SND frames (0 = run forever)")
    k.add_argument("--rigctld-port", type=int, default=None,
                   help="serve a rigctld emulator on this port")
    k.add_argument("--waterfall-png", default=None,
                   help="also open a W/F stream and write a waterfall PNG")
    k.add_argument("--record-iq", default=None,
                   help="record the raw IQ stream to a KiwiSDR-format WAV")
    k.add_argument("--pipeline", type=int, default=0,
                   help="device dispatch pipeline depth (N blocks in "
                        "flight; hides the host-device round trip at +N "
                        "blocks of latency)")
    k.add_argument("--tui", action="store_true",
                   help="interactive terminal panadapter (live waterfall, "
                        "keyboard tuning, dual RX, CAT sync); not ported "
                        "yet")
    _add_device(k)

    tu = sub.add_parser("tui", help="terminal panadapter over a recorded "
                                    "IQ WAV (ANSI spectrum + waterfall); "
                                    "not ported yet")
    tu.add_argument("input")
    tu.add_argument("--mode", default="AM")
    tu.add_argument("-f", "--freq", type=float, default=14200.0)
    tu.add_argument("-r", "--fps", type=float, default=0.0,
                    help="cap refresh rate (0 = pace by playback speed)")
    tu.add_argument("-W", "--width", type=int, default=0,
                    help="display width in columns (0 = fit terminal)")
    tu.add_argument("-H", "--height", type=int, default=0,
                    help="waterfall history rows (0 = fit terminal)")
    tu.add_argument("--speed", type=float, default=4.0,
                    help="playback speed multiple of realtime")

    mo = sub.add_parser("monitor", help="wideband monitor: channelized "
                        "band RSSI/activity view + select-to-audio; not "
                        "ported yet")
    mo.add_argument("input", nargs="?", default=None,
                    help="wideband IQ WAV (omit to stream live IQ from "
                         "--kiwiserver)")
    mo.add_argument("--n-chan", type=int, default=100)
    mo.add_argument("--mode", default="AM",
                    choices=["AM", "USB", "LSB", "CW", "NBFM"])
    mo.add_argument("--thresh", type=float, default=-90.0,
                    help="activity squelch threshold, RSSI dB")
    mo.add_argument("--select", type=float, default=None,
                    help="select the channel nearest this kHz offset")
    mo.add_argument("--record", default=None,
                    help="record the selected channel's audio to WAV")
    mo.add_argument("--headless", action="store_true",
                    help="no TTY UI; print table snapshots")
    mo.add_argument("--max-chunks", type=int, default=0)
    mo.add_argument("--print-every", type=int, default=4)
    mo.add_argument("--rate", type=int, default=12000,
                    help="live mode: per-channel IQ rate (fs_in/n_chan)")
    mo.add_argument("--frames", type=int, default=0,
                    help="live mode: stop after N SND frames (0 = run)")
    mo.add_argument("-s", "--kiwiserver", default="kiwisdr.local")
    mo.add_argument("-p", "--kiwiport", type=int, default=8073)
    mo.add_argument("-w", "--password", default="")
    mo.add_argument("-f", "--freq", type=float, default=10000.0)

    sub.add_parser("bench", help="run the single-chip benchmark; not "
                                 "ported yet")
    return ap


def cmd_demod(args) -> int:
    from supersdr_tpu_torch.io import wav
    from supersdr_tpu_torch.runtime import chain

    t, z = wav.read_kiwi_iq_wav(args.input)
    fs = int(round(1.0 / np.median(np.diff(t[:10000]))))
    # snap to a standard kiwi rate
    fs = min((12000, 20250, 24000, 48000), key=lambda r: abs(r - fs))
    # sound-card-standard output rate as the reference (48 kHz; 20.25 kHz
    # kiwis go through the rational L/M resampler, utils:1126)
    audio_rate = 48000
    M = fs // int(np.gcd(fs, audio_rate))
    chunk = (8192 // M) * M
    cfg = chain.ChainConfig(mode=args.mode, iq_rate=fs, audio_rate=audio_rate,
                            chunk=chunk, os_block=chunk,
                            passband_impl=args.passband)
    agc_kwargs = (dict(on=False) if args.agc_off
                  else dict(decay_ms=float(args.agc_decay),
                            thresh_db=float(args.agc_thresh)))
    params = chain.make_params(cfg, freq_offset_hz=args.freq_offset,
                               low_cut=args.low_cut, high_cut=args.high_cut,
                               agc_kwargs=agc_kwargs, device=args.device)
    _, audio, rssi = chain.run_offline(cfg, params, z.astype(np.complex64))
    rec = wav.AudioRecorder(audio_rate)
    rec.start(args.output)
    rec.append(np.clip(audio, -1, 1))
    rec.stop()
    print(f"wrote {args.output}: {len(audio)} samples @ {audio_rate} Hz, "
          f"mean RSSI {np.mean(rssi):.1f} dB")
    return 0


def cmd_waterfall(args) -> int:
    from supersdr_tpu_torch.display import png, render
    from supersdr_tpu_torch.io import wav
    from supersdr_tpu_torch.ops import spectrum

    t, z = wav.read_kiwi_iq_wav(args.input)
    win = spectrum.spectrum_window(args.nfft, device=args.device)
    db = spectrum.waterfall_rows_db(z.astype(np.complex64), win, args.nfft)
    db = spectrum.time_binned_average(db, max(1, args.avg))
    res = spectrum.autolevel(db)
    color = res.color.cpu().numpy()[::-1]  # newest row on top
    markers = None
    if args.freq is not None and not args.no_eibi:
        fs = int(round(1.0 / np.median(np.diff(t[:10000]))))
        span_khz = fs / 1000.0
        start = args.freq - span_khz / 2
        from supersdr_tpu_torch.control import beacons as bcn
        from supersdr_tpu_torch.control.eibi import EibiDb
        from supersdr_tpu_torch.display.render import (BEACON_MARKER,
                                                       EIBI_MARKER)
        eibi = EibiDb()
        to_bin = lambda f: int((f - start) / span_khz * args.nfft)
        markers = [(to_bin(f), EIBI_MARKER)
                   for f in eibi.get_stations(start, start + span_khz)]
        markers += [(to_bin(bcn.FREQ_KHZ[b]), BEACON_MARKER)
                    for b in bcn.which_beacons()]
    img = render.render_panadapter(color, palette_name=args.colormap,
                                   markers=markers)
    png.write_png(args.output, img)
    print(f"wrote {args.output}: {color.shape[0]} rows x {args.nfft} bins, "
          f"dB window [{float(np.median(res.low_db.cpu().numpy())):.1f}, "
          f"{float(np.median(res.high_db.cpu().numpy())):.1f}]")
    return 0


def cmd_wideband(args) -> int:
    from pathlib import Path

    from supersdr_tpu_torch.io import wav
    from supersdr_tpu_torch.runtime import wideband

    t, z = wav.read_kiwi_iq_wav(args.input)
    fs = int(round(1.0 / np.median(np.diff(t[:10000]))))
    n_chan = args.n_chan
    fs_eff = (fs // n_chan) * n_chan
    # chunk on 8-FRAME multiples: the fused kernels' window DMAs are
    # 8-row aligned, and GNSS-chunked WAV readback lengths are rarely
    # 8-frame multiples themselves — plain n_chan rounding would push
    # every file-driven run onto the slow fallback tier (≤7 frames per
    # chunk boundary are dropped instead, and counted below)
    chunk_in = (min(len(z), fs_eff) // (8 * n_chan)) * (8 * n_chan)
    if chunk_in == 0:
        chunk_in = (min(len(z), fs_eff) // n_chan) * n_chan
    if chunk_in == 0:
        print("capture too short for this channel count")
        return 1
    n_read = len(z)
    z = z[: (len(z) // chunk_in) * chunk_in]
    tuning = dict(passband_impl=args.passband)
    if getattr(args, "profile", None):
        from supersdr_tpu_torch.ops import channelizer as chz
        if args.passband != "fft":
            # the profile defines the whole tuning dict; a silent discard
            # of an explicit --passband measured the wrong thing — refuse
            # the ambiguous combination instead
            print("--profile selects the full kernel tuning (including "
                  "the passband implementation); drop --passband or "
                  "drop --profile")
            return 2
        tuning = dict(wideband.PROFILES[args.profile])
        if not chz.mxu2_supported(n_chan):
            tuning["chan_impl"] = "legacy"   # e.g. large-prime n_chan
    cfg = wideband.WidebandConfig(fs_in=fs_eff, n_chan=n_chan,
                                  chunk_in=chunk_in, mode=args.mode,
                                  audio_rate=4 * fs_eff // n_chan,
                                  **tuning)
    params = wideband.make_params(cfg, device=args.device)
    state = wideband.init_state(cfg, device=args.device)
    audio_parts = []
    for i in range(0, len(z) - cfg.chunk_in + 1, cfg.chunk_in):
        state, out = wideband.process(cfg, params, state,
                                      z[i:i + cfg.chunk_in].astype(np.complex64))
        a = out.audio.float()
        if cfg.time_major:
            a = a.T      # [frames·L, n_chan] -> [n_chan, frames·L]
        audio_parts.append(a.cpu().numpy())
    audio = np.concatenate(audio_parts, axis=-1)
    level = np.sqrt(np.mean(audio ** 2, axis=-1))
    order = np.argsort(level)[::-1]
    freqs = wideband.channel_freqs(cfg)
    outdir = Path(args.outdir)
    outdir.mkdir(exist_ok=True)
    for ch in order[: args.top]:
        rec = wav.AudioRecorder(cfg.audio_rate)
        name = outdir / f"chan_{ch:03d}_{freqs[ch] / 1000:+.1f}kHz.wav"
        rec.start(str(name))
        rec.append(np.clip(audio[ch], -1, 1))
        rec.stop()
        print(f"  {name}  rms={level[ch]:.4f}")
    print(f"channelized {len(z)} samples into {n_chan} channels")
    print(f"did not process the last {n_read - len(z)} samples (less than "
          f"one chunk of {chunk_in})")
    return 0


def cmd_kiwi(args) -> int:
    from supersdr_tpu_torch.apps.kiwi_session import run_kiwi_session

    return run_kiwi_session(args)


def cmd_bench(args) -> int:
    raise NotImplementedError(
        "bench: the port has no benchmark yet (ROADMAP queue 1 #11)")


def cmd_monitor(args) -> int:
    raise NotImplementedError(
        "monitor (apps/monitor) is not ported yet: ROADMAP queue 1 #9, "
        "slice 7")


def cmd_tui(args) -> int:
    raise NotImplementedError(
        "tui (apps/tui) is not ported yet: ROADMAP queue 1 #9, slice 7")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if hasattr(args, "device"):
        # resolved before any work: with no card and no --device this
        # raises, as every constructor of the port does
        args.device = default_device(args.device)
    return {"demod": cmd_demod, "waterfall": cmd_waterfall,
            "wideband": cmd_wideband, "kiwi": cmd_kiwi,
            "bench": cmd_bench, "tui": cmd_tui,
            "monitor": cmd_monitor}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
