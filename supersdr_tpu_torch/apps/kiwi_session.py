"""Live KiwiSDR session: IQ from the server, demodulation on the card.

Counterpart of the reference's `apps/kiwi_session.py`.

Where the reference asks the KiwiSDR to demodulate (`SET mod=usb …`) and
plays the returned 12 kHz audio, this session requests the **IQ stream**
and runs the port's receiver chain — the server becomes a dumb digitizer
and every control (mode, passband, AGC) acts on our own DSP, with the same
knob semantics. The session wires together:

  KiwiClient (SND/iq) → drift compensation → Receiver.process (device) →
  latency governor → FrameBuffer → WAV / sound-device sink,
  with optional rigctld emulation (fldigi/wsjtx can tune us) and CAT sync
  to a physical radio via a hamlib rigctld (LinkController).

The receiver runs on `args.device` (None: the current CUDA device), and
so do the interactive panadapter's (`--tui`, `run_kiwi_tui`: the live
waterfall, keyboard tuning, dual RX and the server book over
`apps/live_tui.LiveTui`).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from supersdr_tpu_torch.control.bandplan import get_auto_mode
from supersdr_tpu_torch.control.links import LinkController
from supersdr_tpu_torch.control.panadapter import Panadapter
from supersdr_tpu_torch.control.receiver import Flags, Receiver
from supersdr_tpu_torch.io import audio_sink, kiwi_protocol as kp
from supersdr_tpu_torch.io.kiwi_client import (
    KiwiClient, KiwiError, KiwiServerTerminatedConnection, KiwiTooBusyError)
from supersdr_tpu_torch.io.rigctl import CatClient, RigctldServer
from supersdr_tpu_torch.io.status import KiwiGateError, KiwiStatus
from supersdr_tpu_torch.runtime import chain
from supersdr_tpu_torch.runtime.engine import (EngineConfig, SourceBusy,
                                               SourceClosed, StreamEngine)
from supersdr_tpu_torch.runtime.governor import (DriftCompensator,
                                                 LatencyGovernor)


def _gate_and_connect(args):
    """Pre-connect health gate + connect/negotiate (utils:648-657,
    960-994 semantics). Returns (client, first_frame, kiwi_rate,
    true_rate, freq_offset_khz) or raises KiwiGateError."""
    try:
        status = KiwiStatus.fetch(args.kiwiserver, args.kiwiport)
        status.gate()
        freq_offset_khz = status.freq_offset_hz / 1000.0
    except OSError:
        freq_offset_khz = 0.0  # old firmware without /status

    client = KiwiClient(args.kiwiserver, args.kiwiport, args.password)
    client.connect()
    client.setup_sound("IQ", -5000, 5000, args.freq)
    first = client.wait_for_stream()
    kiwi_rate = client.info.audio_rate or 12000
    true_rate = client.info.audio_rate_true or float(kiwi_rate)
    print(f"connected: {args.kiwiserver}:{args.kiwiport} "
          f"rate={kiwi_rate} (true {true_rate:.2f})")
    return client, first, kiwi_rate, true_rate, freq_offset_khz


def _session_chain_cfg(mode: str, kiwi_rate: int, chunk: int
                       ) -> chain.ChainConfig:
    """48 kHz output like the reference sound path; 20.25 kHz kiwis go
    through the rational resampler (chunk snapped to a multiple of M)."""
    audio_rate = 48000
    M = kiwi_rate // int(np.gcd(kiwi_rate, audio_rate))
    chunk = max(M, (chunk // M) * M)
    return chain.ChainConfig(mode=mode, iq_rate=kiwi_rate,
                             audio_rate=audio_rate, chunk=chunk,
                             os_block=chunk)


def run_kiwi_session(args) -> int:
    if getattr(args, "tui", False):
        return run_kiwi_tui(args)
    try:
        client, first, kiwi_rate, true_rate, freq_offset_khz = \
            _gate_and_connect(args)
    except KiwiGateError as e:
        print(f"refusing to connect: {e}")
        return 1

    mode = (args.mode or get_auto_mode(args.freq)).upper()
    cfg = _session_chain_cfg(mode, kiwi_rate, 2048)
    chunk = cfg.chunk
    rx = Receiver(cfg=cfg, center_freq_khz=args.freq, freq=args.freq,
                  radio_mode=mode, device=getattr(args, "device", None))
    pan = Panadapter(zoom=args.zoom, freq_khz=args.freq)
    links = LinkController(wf=pan, rx=rx, flags=Flags())
    if args.radioserver:
        cat = CatClient(args.radioserver, args.radioport)
        links.cat = cat if cat.cat_ok else None

    rigctld = None
    if args.rigctld_port is not None:
        rigctld = RigctldServer(rx, port=args.rigctld_port)
        threading.Thread(target=rigctld.serve_forever, daemon=True).start()
        print(f"rigctld emulator on port {rigctld.port}")

    # optional second stream: live waterfall rows → PNG at session end
    # (the reference's kiwi_waterfall.run loop, utils:879-898, headless)
    wf_rows: list[np.ndarray] = []
    wf_thread = None
    wf_client = None
    if getattr(args, "waterfall_png", None):
        wf_client = KiwiClient(args.kiwiserver, args.kiwiport, args.password,
                               stream_type="W/F",
                               timestamp=client.timestamp)
        wf_client.connect()
        wf_client.setup_waterfall(zoom=pan.zoom, counter=pan.counter)

        def _wf_loop():
            while True:
                try:
                    msg = wf_client.read()
                except (KiwiError, OSError, ValueError):
                    # stream over / socket torn down mid-read — the
                    # reader thread just ends, like the reference's
                    # wf thread on kiwi_wf.terminate
                    return
                if isinstance(msg, kp.WfFrame):
                    wf_rows.append(wf_client.wf_bins(msg))
                    try:
                        wf_client.keepalive()
                    except OSError:
                        pass

        wf_thread = threading.Thread(target=_wf_loop, daemon=True)
        wf_thread.start()

    iq_recorder: list[np.ndarray] = []

    # -------- source: SND frames → fixed chunks
    frames_seen = [0]

    def source_factory():
        def gen():
            buf = np.zeros(0, np.complex64)
            # include the frame already received during negotiation
            pending = [first]
            while True:
                if args.frames and frames_seen[0] >= args.frames:
                    return
                frame = pending.pop() if pending else None
                if frame is None:
                    try:
                        msg = client.read()
                    except KiwiTooBusyError:
                        raise SourceBusy() from None
                    except (KiwiServerTerminatedConnection, KiwiError):
                        raise SourceClosed() from None
                    if not isinstance(msg, kp.SndFrame):
                        continue
                    frame = msg
                kind, gps, z = client.snd_samples(frame)
                if kind != "iq":
                    continue
                if getattr(args, "record_iq", None):
                    iq_recorder.append(z.astype(np.complex64) / 65535.0)
                frames_seen[0] += 1
                try:
                    client.keepalive()
                except OSError:
                    pass  # keep draining buffered frames past a server close
                buf = np.concatenate([buf, z.astype(np.complex64) / 32768.0])
                while len(buf) >= chunk:
                    yield buf[:chunk]
                    buf = buf[chunk:]
        return gen()

    governor = LatencyGovernor(buffer_frames=args.buffer,
                               ms_per_frame=chunk / true_rate * 1000.0)
    drift = DriftCompensator(nominal_rate=kiwi_rate, true_rate=true_rate,
                             frame=chunk)
    engine = StreamEngine(source_factory, process=rx.process,
                          process_dispatch=rx.process_dispatch,
                          process_fetch=rx.process_fetch,
                          config=EngineConfig(
                              buffer_frames=args.buffer,
                              connect_retries=1,
                              pipeline_depth=getattr(args, "pipeline", 0)),
                          governor=governor, drift=drift)

    # -------- sink
    if args.output:
        sink = audio_sink.WavFileSink(args.output, audio_rate=cfg.audio_rate)
    else:
        sd = audio_sink.SoundDeviceSink(audio_rate=cfg.audio_rate,
                                        blocksize=chunk * 4)
        sink = sd if not sd.unavailable else audio_sink.WavFileSink(
            "kiwi_audio.wav", audio_rate=cfg.audio_rate)

    engine.start()
    sink.start(lambda: engine.pop_audio(timeout=1.0))
    try:
        while engine.status not in ("stopped",):
            links.poll_cat()
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        engine.stop()
        # let the sink drain buffered audio before closing it
        deadline = time.monotonic() + 10.0
        while engine.buffer.qsize() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        out = sink.stop()
        if out:
            print(f"audio written to {out}")
        client.close()
        if wf_client is not None:
            wf_client.close()
            if wf_thread is not None:
                wf_thread.join(timeout=2)
            if wf_rows:
                from supersdr_tpu_torch.display import png, render
                from supersdr_tpu_torch.ops import spectrum
                db = spectrum.kiwi_byte_to_db(
                    torch.from_numpy(np.stack(wf_rows[::-1])).to(rx.device),
                    pan.zoom)
                res = spectrum.autolevel(db)
                img = render.render_panadapter(res.color.cpu().numpy(),
                                               palette_name=args.colormap)
                png.write_png(args.waterfall_png, img)
                print(f"waterfall written to {args.waterfall_png} "
                      f"({len(wf_rows)} rows)")
        if getattr(args, "record_iq", None) and iq_recorder:
            from supersdr_tpu_torch.io import wav as wav_io
            wav_io.write_kiwi_iq_wav(args.record_iq,
                                     np.concatenate(iq_recorder),
                                     kiwi_rate, true_rate=true_rate)
            print(f"IQ recorded to {args.record_iq}")
        if rigctld:
            rigctld.close()
    print(f"session done: {frames_seen[0]} frames, "
          f"{engine.dropped_frames} dropped, RSSI {rx.smoothed_rssi:.1f} dB")
    return 0


def run_kiwi_tui(args) -> int:
    """Live interactive panadapter (reference supersdr.py:179-1073): IQ
    stream → native chains + FFT waterfall, keyboard tuning/mode/zoom,
    dual RX (y/Y/n), CAT sync — rendered as ANSI in the terminal. The
    receivers and the native waterfall run on `args.device` (None: the
    current CUDA device)."""
    import sys

    from supersdr_tpu_torch.apps.live_tui import (LiveTui, ansi_render,
                                                  stdin_keys)

    try:
        client, first, kiwi_rate, true_rate, _ = _gate_and_connect(args)
    except KiwiGateError as e:
        print(f"refusing to connect: {e}")
        return 1

    mode = (args.mode or get_auto_mode(args.freq)).upper()
    cfg = _session_chain_cfg(mode, kiwi_rate, 2048)
    chunk = cfg.chunk
    rx = Receiver(cfg=cfg, center_freq_khz=args.freq, freq=args.freq,
                  radio_mode=mode, device=getattr(args, "device", None))
    pan = Panadapter(zoom=args.zoom, freq_khz=args.freq)
    cat = None
    if args.radioserver:
        c = CatClient(args.radioserver, args.radioport)
        cat = c if c.cat_ok else None
    import shutil
    term = shutil.get_terminal_size((100, 30))
    session = LiveTui.create(rx, pan, width=min(term.columns - 2, 160),
                             wf_height=max(4, term.lines - 7), cat=cat)

    # mutable link state so interactive server switching can swap the
    # live SND/W/F clients between chunks (reference connect_new flow,
    # supersdr.py:743-796)
    st = {"client": client, "pending": [first], "chunk": chunk,
          "rate": kiwi_rate, "buf": np.zeros(0, np.complex64),
          "wf": None}

    # wide-span waterfall from the server's W/F stream (the reference's
    # kiwi_waterfall loop, utils:879-898); native IQ rows are the
    # fallback when a second channel slot isn't available
    from supersdr_tpu_torch.apps.live_tui import wf_row_to_color
    wf_state = {"zoom": pan.zoom, "counter": pan.counter}

    def _start_wf(host, port, password, timestamp):
        try:
            wfc = KiwiClient(host, port, password, stream_type="W/F",
                             timestamp=timestamp)
            wfc.connect()
            wfc.setup_waterfall(zoom=pan.zoom, counter=pan.counter)
        except (KiwiError, OSError):
            return None
        session.native_waterfall = False

        def _wf_loop():
            while True:
                try:
                    msg = wfc.read()
                except (KiwiError, OSError, ValueError):
                    return
                if st["wf"] is not wfc:
                    return  # superseded by a server switch
                if isinstance(msg, kp.WfFrame):
                    session.model.push_row(wf_row_to_color(
                        wfc.wf_bins(msg), wf_state["zoom"],
                        session.model.wf_delta_low_db,
                        session.model.wf_delta_high_db))
                    try:
                        wfc.keepalive()
                    except OSError:
                        pass

        threading.Thread(target=_wf_loop, daemon=True).start()
        return wfc

    st["wf"] = _start_wf(args.kiwiserver, args.kiwiport, args.password,
                         client.timestamp)

    def wf_sync():
        """Re-tune the W/F stream when zoom/span keys moved the span
        (reference set_freq_zoom → SET zoom=.. start=.., utils:815-845)."""
        if st["wf"] is None:
            return
        if (pan.zoom, pan.counter) != (wf_state["zoom"], wf_state["counter"]):
            wf_state["zoom"], wf_state["counter"] = pan.zoom, pan.counter
            try:
                st["wf"].send(kp.set_zoom_start(pan.zoom, pan.counter))
            except OSError:
                pass

    # -------- interactive server switching (LiveTui `K` menu)
    from supersdr_tpu_torch.control.kiwilist import KiwiList
    session.server_book = KiwiList(getattr(args, "kiwi_list", None)
                                   or "kiwi.list")

    def do_switch(entry):
        """Connect to the book entry; on any failure the current server
        keeps streaming untouched (connect-before-close is strictly
        safer than the reference's close-then-revert, supersdr.py:743-796
        — no audible gap on a failed switch)."""
        host, port, password = entry[0], entry[1], entry[2]
        try:
            status = KiwiStatus.fetch(host, port)
            status.gate()
        except KiwiGateError as e:
            return False, f"switch refused: {e} — staying"
        except OSError:
            pass  # old firmware without /status
        try:
            nc = KiwiClient(host, port, password)
            nc.connect()
            nc.setup_sound("IQ", -5000, 5000, rx.freq)
            nf = nc.wait_for_stream()
        except (KiwiError, OSError) as e:
            return False, f"switch failed ({type(e).__name__}) — staying"
        new_rate = nc.info.audio_rate or 12000
        old = st["client"]
        if new_rate != st["rate"]:
            # different IQ rate: rebuild the chain cfg, reset the stream
            # state (the reference rebuilds kiwi_sound outright)
            cfg2 = _session_chain_cfg(rx.radio_mode, new_rate, 2048)
            rx.cfg = cfg2
            rx.state = None
            rx.refresh_params()
            st["chunk"] = cfg2.chunk
            st["rate"] = new_rate
        st["client"] = nc
        st["pending"] = [nf]
        st["buf"] = np.zeros(0, np.complex64)
        try:
            old.close()
        except OSError:
            pass
        if st["wf"] is not None:
            try:
                st["wf"].close()
            except OSError:
                pass
        st["wf"] = _start_wf(host, port, password, nc.timestamp)
        return True, f"switched to {host}:{port}"

    session.switch_server = do_switch

    frames_seen = [0]

    def source():
        while True:
            if args.frames and frames_seen[0] >= args.frames:
                return
            cli = st["client"]
            frame = st["pending"].pop() if st["pending"] else None
            if frame is None:
                try:
                    msg = cli.read()
                except (KiwiError, OSError):
                    if st["client"] is not cli:
                        continue  # server switch closed this client
                    return
                if not isinstance(msg, kp.SndFrame):
                    continue
                frame = msg
            kind, gps, z = cli.snd_samples(frame)
            if kind != "iq":
                continue
            frames_seen[0] += 1
            try:
                cli.keepalive()
            except OSError:
                pass
            st["buf"] = np.concatenate([st["buf"],
                                        z.astype(np.complex64) / 32768.0])
            while len(st["buf"]) >= st["chunk"]:
                yield st["buf"][:st["chunk"]]
                st["buf"] = st["buf"][st["chunk"]:]

    wav_q = None
    if args.output:
        rec_sink = audio_sink.WavFileSink(args.output,
                                          audio_rate=cfg.audio_rate)
        # the WAV sink's pump thread waits on a queue for each chunk (the
        # reference's pump spins on an empty list, holding the GIL the
        # session's own thread needs)
        wav_q = queue.Queue()

        def pull():
            try:
                return wav_q.get(timeout=0.05)
            except queue.Empty:
                return None
        rec_sink.start(pull)
        sink = wav_q.put
    else:
        sd = audio_sink.SoundDeviceSink(audio_rate=cfg.audio_rate,
                                        blocksize=cfg.audio_chunk)
        if sd.unavailable:
            rec_sink, sink = None, None
        else:
            frames_q = []
            sd.start(lambda: frames_q.pop(0) if frames_q else None)
            rec_sink, sink = sd, frames_q.append

    # tests inject a scripted key source via args.inject_keys
    keys = getattr(args, "inject_keys", None)
    if keys is None:
        keys = stdin_keys() if sys.stdin.isatty() else (lambda: [])
    try:
        session.run(source(), keys=keys, sink=sink,
                    render=ansi_render, on_tick=wf_sync)
    except KeyboardInterrupt:
        pass
    finally:
        if hasattr(keys, "restore"):
            keys.restore()
        # let the WAV sink write every chunk before closing it
        deadline = time.monotonic() + 10.0
        while wav_q is not None and not wav_q.empty() \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        if rec_sink is not None:
            out = rec_sink.stop()
            if out:
                print(f"audio written to {out}")
        if st["wf"] is not None:
            st["wf"].close()
        st["client"].close()
    print(f"session done: {frames_seen[0]} frames, "
          f"RSSI {rx.smoothed_rssi:.1f} dB")
    return 0
