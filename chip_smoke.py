"""Smoke test of the PyTorch port on one CUDA card (an H100, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. card identity (torch / CUDA versions, nvidia-smi name and power limit);
  2. build the kernels from supersdr_tpu_torch/csrc with nvcc (one
     process a source, in parallel): the seconds each source took, every
     kernel variant's registers, stack and spills, and the tensor-core and
     asynchronous-copy instructions in the built library; and the port's
     default device (no `device` given: the current card);
  3. each kernel's wrapper against its plain PyTorch version on the card,
     at the MID shape (2560 channels, 512 frames a chunk): the channelizer
     on both tiers with float32 and int16 input (also at 2 × 256, 12 × 256
     and 5 × 512 channels, 40 frames), the FIR tail on AM, USB
     (complex taps) and NBFM on both tiers and with AGC hang (also on 10
     planes of 40 channels, both tiers), the fold, and
     the non-FIR tail on AM with hang off and on (500 and 40 ms), USB, NBFM
     (FM carriers, manual AGC), with the power row, handed the complex
     passband itself (also 2547 and 2548 channels; rows at an odd offset,
     and chain-major audio from the planes' entry, must be refused) and on
     time-major planes (also 2548 and 40 channels: the last cluster of
     four blocks short); peak segments shorter than, as long as and longer
     than the tails' 256-sample scan piece; plus ragged last tiles (13
     frames for the channelizer and the fold, 640 for both tails); the
     channelizer's time-major store (float32 and int16 input) and the FIR
     tail's 2-D source; and the halo kernel, bit for bit, over float32,
     int16 and complex64, 1 to 256 samples, 1 to 8 shards, 1 to 2560 rows,
     strided sources, a −inf fill, two hops and a head for shard 0;
  4. the planar main path, `wideband.process_n`, at the HEADLINE shape
     (2560 channels, 16128 frames a chunk) on both profiles with float32
     and int16 chunks: launch counts and audio checks; then the chan-major
     main path (CHANMAJOR: the same shape, `time_major=False`,
     `pallas_fold=True`, the fft passband and the tail kernel): one fold
     and one non-FIR tail launch a chunk, audio [2560, 64512]; then ms a
     chunk, input Msamples/s, each kernel against and beside its plain
     version at HEADLINE (the channelizer also on int16 chunks, both tails
     also on USB, NBFM and AM with the hang), what every channelizer
     instance launches at HEADLINE and at the mesh's (20, 128) on 8 shards
     (registers, local bytes, shared bytes, grid, blocks an SM, frames a
     block, its tables' bytes and what a block reads of them out of L2),
     what each tail entry launches
     (registers, stack, shared bytes, grid, blocks an SM, cluster dims and
     the clusters resident at once; every FIR-tail instance), and where the
     planar and the CHANMAJOR device time goes, with the card's idle share;
  5. row alignment on both main paths: two AM carriers come out as the two
     loudest RSSI rows;
  6. AGC hang and squelch on the planar HEADLINE path (launch counts
     unchanged, and one squelch-gate launch a chunk with the squelch); the
     squelch gate kernel against its plain version on HEADLINE's audio
     [64512, 2560] (float32, float16, bfloat16; the squelch cell's mix of
     settled-open, settled-shut and moving channels): equal up to the sign
     of zero, its ms beside its bound (~0.19 ms at float32); and the
     chain's own entry points: `chain.process` on 2560
     receivers with the tail kernel, `chain.run_offline` for one 12 kHz and
     one 20.25 kHz receiver, and a MID chan-major run through the fused
     channelizer and the tail kernel, each held against the same call on
     the CPU; the non-FIR tail as `chain.process` runs it on 128 and 2560
     receivers × 2048 (against its plain version, timed, with its grid,
     and the call's ms);
  6b. the reference's channelizer and passband variants (`variants`):
     each chan-major `chan_impl` route (`stub`, `nofft`, `mxu2`, `mxu2`
     with a float16 fold, `mxu2conv`, `mxu2pallas`, `dit`, `legacy` with
     `mxu_chan_fft`) at MID behind the tail kernel against the same
     config on the CPU (`stub` also bit for bit at the channelizer;
     `mxu2pallas` one fold launch a chunk); `passband_impl="fftmxu"`
     through `chain.process` on 128 receivers and through `sharded_chain`
     (the halo kernel), against the CPU; the off-air fixture through
     `cli demod --mode AM --agc-off` against the reference's scipy oracle
     (≥ 40 dB); each route's ms a chunk at HEADLINE beside CHANMAJOR's,
     with the card's name and power limit;
  7. the sharded receiver chain (SHARDED: `parallel.sharded_chain.build` on
     8 receivers × 8 time shards of 131072 samples, AM with the matmul
     passband, and on a 2 × 4 chan × time grid, USB with the fft passband;
     two chained calls each): halo-kernel launches with halo_impl="rdma",
     none with "ppermute", identical audio, and the sharded audio against
     the serial chain on the card and the same call on the CPU; the halo
     kernel timed beside an empty launch, its plain version and the slice
     copy PyTorch would make;
  7b. the mesh across processes on the one card (`procs`): 2, then 4
     ranks spawned by `parallel.launch.spawn` (a gloo group for the
     handshakes), each loading the built library: every primitive of
     `collectives.ProcessTransport` against the one-process transport bit
     for bit, the halo kernel pushing into the other ranks' buffers over
     CUDA IPC (launches by rank), the ordering under a rank held back by
     `torch.cuda._sleep` over three chained calls, the halo's µs a call
     across processes, SHARDED over the ranks against one process (≥
     TOL_SNR_DB["cpu"] or bit-identical) and, over 2 ranks, HEADLINE fast
     through `sharded_wideband` on 8 shards against the one-process mesh
     (gathered rows, bit for bit); ms a call and a chunk against one
     process;
  8. the time-major tier off the planar coupling (TMAJOR: the HEADLINE
     config with 16200 frames a chunk, both profiles, and a 33-tap passband
     that has no in-tail FIR block): launch counts, audio against the
     chan-major tier on the card, ms a chunk, and both kernels against
     their plain versions at that shape, the non-FIR tail on the time-major
     passband that branch produced;
  9. the sharded wideband pipeline (MESH: `parallel.sharded_wideband.build`
     at HEADLINE on 8 shards of the card ((20, 128) with 24 planes, 4 of
     them phantom), 4 ((20, 128)) and 2 (the serial (10, 256)), fast, and on
     8 quality; two chained calls of two chunks, float32 then int16): one
     channelizer, one FIR-tail and one halo launch a chunk, the counted
     traffic equal to `comm_model.wideband_comm_model`, the audio and RSSI
     rows bit-identical to the serial planar path on the same factoring and
     within TOL_TIER_DB of the serial quality path; ms a chunk beside serial
     planar, the idle share and a profile on 8 shards; the channelizer's mesh
     form (8 shards, n1_out = 24; phantom planes exactly 0) and the FIR tail
     on the resharded [24, frames, 128] planes against their plain versions
     (also at MID in phase 3), timed; the time-major and fallback tiers on 8
     shards at MID against the same calls on the CPU; the distributed FFT
     against torch.fft.fft, the 2-stage pipeline against the serial
     wideband, and the dry run of every mesh form on 8 shards;
 10. the port's CLI on the card (`cli`), through `cli.main` with no
     --device, on WAVs the port's `io/wav` writes in a temporary
     directory: `demod` on the off-air-style fixture and on a 20.25 kHz
     USB capture and `waterfall --avg 10` on the fixture, each against the
     same call with --device cpu; `wideband --n-chan 2560 --profile fast`
     and `quality` on a 0.992 s capture at 30.72 MHz (the tier it took,
     each kernel's launches from a zeroed count, the wall split into WAV
     read, staging, `process` and WAV writes), and the same calls at MID
     on the card and on the CPU;
 11. the live session (`session`): `cli kiwi` against the port's fake
     KiwiSDR on localhost for 240 frames at 12 kHz and at 20.25 kHz (the
     served tone comes out of the recorded WAV), the session's own
     `Receiver.process` times, then `Receiver.process` and
     `DualChain.process` (MAIN + SUB) timed over 256 chunks: p50/p99
     against the chunk's real-time budget, and where the card's time
     goes in them. The fold's library time (`F.conv1d(groups=M)`, cuDNN)
     is taken at HEADLINE beside the fold kernel's;
 12. the wideband monitor (`monitor`): `apps.monitor.MonitorCore` over the
     HEADLINE fast config (planar) on three chunks of the CLI's six AM
     carriers held on the card, fed as complex64 and as int16 wire pairs,
     each against the same run with the plain kernels on the card (the
     activity rows and frequencies, the RSSI table within 0.05 dB, the
     selected channel's recording at TOL_WAV_DB["fast"]); over
     `sharded_wideband.build` on 8 shards (the same carriers); ms a chunk
     of `push` and of its host copies; `cli monitor --n-chan 2560
     --headless` (the reference's defaults: chan-major, no kernel) on the
     CLI's 30.72 MHz WAV, the card against --device cpu;
 12b. the live monitor's held graph (`graph`): `MonitorCore`'s graphed
     process function at MID (the live cell's 512 frames) on both tiers
     against its eager one, 64 wire chunks from pinned memory: audio, RSSI
     and the final state bit for bit, with a foreign state copied in, an
     AGC parameter written in place and a new parameters object each read
     by the next chunk; one launch of each counted kernel a replay, and
     both kernels once a chunk in a profiler trace of 8 replays; push +
     fetch p50 / p95 ms graphed against eager;
 13. the live interactive session (`live`): `cli kiwi --tui` against the
     fake KiwiSDR with keys injected (SUB on, SUB to the centre, AM, a
     retune, SUB off), the stereo WAV on the card against --device cpu;
     `LiveTui.step` (MAIN + SUB and the native waterfall) p50/p99 over 256
     chunks of 2048 samples at 12 kHz; `run_tui_wav` on the fixture, the
     waterfall history on the card against the CPU;
 14. stream checkpoint/resume (`checkpoint`): HEADLINE fast planar, 4
     chunks straight against 2, `save_state`, `load_state`, 2 more, audio
     and RSSI bit-identical; the same for one receiver's chain;
 15. device tracing (`trace`): `utils.profiling.trace` around one
     `process_n` call at HEADLINE; the written Chrome trace names the
     channelizer and FIR-tail kernels; the traced call's time beside an
     untraced one;
 16. the port's benchmark (`bench`, run after phase 4's timing):
     `supersdr_tpu_torch.bench.results` in this process, the measurement
     `cli bench` prints, both tiers at HEADLINE: its four oracle gates
     (each ≥ 50 dB, the MID gates' fixture rows against the JAX package's
     audio too), int16 ingest against the dequantized chunk (> 80
     dB), no error entry, both kernels' launches moved; its JSON line and
     seconds, and its ms a chunk beside phase 4's for the same call;
     the card's idle share in the bench's own loop, profiled.
Each kernel's line in the JSON summary carries its launches on the main
paths, its time, its plain version's, its bound on this card (bytes over
3.35 TB/s against operations over the peak rate of their type;
`kernel_bounds`: the channelizer and the FIR tail as the cells count them,
the channelizer on the int16 input the cells feed) and, where one PyTorch
call computes the same function, that call's time; the channelizer's and
the FIR tail's also their quality tier's times and their times at the
mesh's shapes.
The non-FIR tail has two lines: `chain_tail_am_c` (the complex passband,
chain-major audio: timed at CHANMAJOR and on the two batches) and
`chain_tail_am` (time-major planes: timed at the 33-tap time-major branch).
The squelch gate's line carries its float16 and bfloat16 times too.
The last lines are the kernels' JSON summary and
{"ok": true, "device": {...}}. It exits non-zero, printing no result,
when no CUDA device is present. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MID = dict(fs_in=30_720_000, n_chan=2560, chunk_in=2560 * 512, mode="AM",
           taps_per=8, n_taps=257, audio_rate=48_000)
HEADLINE = dict(MID, chunk_in=2560 * (16384 - 256))
# the chan-major tier at the headline shape: the fold kernel, cuFFT, the
# overlap-save passband and the non-FIR tail kernel
CHANMAJOR = dict(time_major=False, pallas_fold=True, tail_impl="pallas",
                 passband_impl="fft")

# kernel vs plain on the card. Both compute in float32 with other
# summation orders (the tails scan in other pieces than their plain
# versions; the DC pole and the AGC's exp amplify that); the quality
# channelizer's and FIR's float32 operands go through the tensor cores as
# two bf16 pieces each (16 significant bits, ~108 dB); the bf16 tier's raw
# planes are rounded to bf16 on output, where an order-level difference
# can flip one bf16 ulp. The fold sums 8 float32
# products in the plain version's order. The chain and the chan-major
# tier on the card against the same call on the CPU: float32 with other
# FFT and summation orders, the tail bound again.
TOL_SNR_DB = {"chan_fast": 50.0, "chan_quality": 100.0, "tail": 80.0,
              "fold": 110.0, "cpu": 80.0}
# the time-major tier against the chan-major tier on the card: the fast
# profile's FIR tail rounds its operands to bf16, the chan-major passband
# is a float32 matmul
TOL_TIER_DB = {"fast": 45.0, "quality": 80.0}

# the time-major tier off the planar coupling: 16200 frames a chunk, which
# neither profile's chan_tile_t divides
TMAJOR = dict(MID, chunk_in=2560 * 16200)
# the sharded wideband: shard counts on the one card (8: (20, 128) with 24
# planes; 4: (20, 128); 2: the serial (10, 256)), the MID tiers' count
MESH_SHARDS = (8, 4, 2)
MESH_D = 8
# the reference's hardware shapes for the sharded chain
SHARDED = dict(mode="AM", iq_rate=12_000, audio_rate=48_000, chunk=1 << 17,
               os_block=1 << 17, n_taps=257, passband_impl="matmul")
SHARDED_RX, SHARDED_D = 8, 8

# H100 SXM data-sheet peaks, for the kernels' bounds
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def bound_ms(n_bytes: float, flops: dict) -> tuple[float, str]:
    """The least time the card could take: every input byte read once and
    every output byte written once over the memory rate, against the
    operations of each type over that type's peak rate (the units run side
    by side, so the slowest one bounds)."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max((n / PEAK_FLOPS[k] for k, n in flops.items()), default=0.0)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double(), got.double()
    den = float(torch.linalg.norm(got - ref))
    if den == 0.0:
        return float("inf")
    return 20.0 * np.log10(float(torch.linalg.norm(ref)) / den)


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _kernel_name(mangled: str) -> str:
    """kernel<template arguments> out of a mangled entry name (the name is
    what ends in `_kernel` and is preceded by its own length)."""
    end = mangled.find("_kernel") + len("_kernel")
    for n in range(len("_kernel"), 64):
        start = end - n
        if start > 0 and mangled[:start].endswith(str(n)) \
                and re.fullmatch(r"[a-z_][a-z0-9_]*", mangled[start:end]):
            m = re.match(r"I((?:L[a-z]\d+E|[a-z])+)E", mangled[end:])
            args = re.findall(r"L[a-z](\d+)E|([a-z])", m.group(1)) if m else []
            return f"{mangled[start:end]}<{','.join(a or b for a, b in args)}>"
    return mangled


def _print_build(log: str, lib_path) -> None:
    """What the compiler said of every kernel variant (registers a thread,
    stack and spill bytes), the seconds each source took, and from the
    built library's SASS the tensor-core (HMMA), asynchronous-copy (LDGSTS)
    and ldmatrix (LDSM) instructions by kernel."""
    name = None
    stack = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1])
        elif "bytes stack frame" in line:
            stack = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"  ptxas {name}: {regs} registers; {stack}", flush=True)
            name = None
        elif line.startswith("nvcc "):
            print(f"  {line}", flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        print("  sass: cuobjdump not found", flush=True)
        return
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        print(f"  sass: cuobjdump failed: {out.stderr.strip()[:200]}",
              flush=True)
        return
    counts: dict = {}
    fn = None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = _kernel_name(line.split(":", 1)[1].strip()).split("<")[0]
            counts.setdefault(fn, {"variants": 0, "HMMA": 0, "LDGSTS": 0,
                                   "LDSM": 0})["variants"] += 1
        elif fn:
            for op in ("HMMA", "LDGSTS", "LDSM"):
                if op in line:
                    counts[fn][op] += 1
    for fn, c in sorted(counts.items()):
        print(f"  sass {fn}: {c['variants']} variants, HMMA {c['HMMA']}, "
              f"LDGSTS {c['LDGSTS']}, LDSM {c['LDSM']} instructions in all",
              flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_queued(fn, iters: int, device) -> float:
    """Mean device time of fn() when the launches are already queued: a
    few large matrix products keep the card busy while the host enqueues
    `iters` calls, so the events bracket work the card runs back to back.
    For calls shorter than the host takes to enqueue them, where `cuda_ms`
    measures the host."""
    a = torch.randn(8192, 8192, device=device)
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(6):
        a @ a
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_share(label: str, step, calls: int = 2, rows: int = 10) -> None:
    """Where the device time of `calls` runs of step() goes, and how much
    of the host's wall the card was idle: kernel events from
    torch.profiler against the wall of the same calls run unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    kernel_ms = sum(e.device_time_total for e in prof.events()
                    if e.device_type == DeviceType.CUDA) * 1e-3
    print(f"profile {label} ({calls} calls): kernel time "
          f"{kernel_ms / calls:.3f} ms a call, host wall "
          f"{wall_ms / calls:.3f} ms a call unprofiled, device idle share "
          f"{max(0.0, 1.0 - kernel_ms / wall_ms) * 100:.1f} %", flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=rows), flush=True)


def _chan_case(cfg, params, gen, *, i16: bool, device,
               nf: int | None = None, layout: str = "raw3"):
    """(wrapper call, plain call) of the channelizer on one random chunk of
    nf frames (default: the config's); layout "time" is the float32
    time-major store."""
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.ops.cuda import channelize_fused as cf
    from supersdr_tpu_torch.runtime import wideband as wb
    plan = wb.pfb_plan(cfg)
    n = (nf or cfg.chunk_per_chan) * cfg.n_chan
    if i16:
        x = tuple((torch.randn(n, generator=gen, device=device) * 1600
                   ).round().to(torch.int16) for _ in range(2))
    else:
        x = cx.CX(*(torch.randn(n, generator=gen, device=device) * 0.05
                    for _ in range(2)))
    carry = cx.CX(*(torch.randn(plan.history, generator=gen,
                                device=device) * 0.05 for _ in range(2)))
    fast = cfg.chan_precision == "default"
    kw = dict(factors=wb._factors_for(cfg), bf16_mxu=fast,
              out_dtype=torch.bfloat16 if fast and layout == "raw3"
              else torch.float32)

    def kernel():
        return cf.channelize_fused_c(plan, params.W_pfb, carry, x,
                                     out_layout=layout, **kw)[1]

    def plain():
        args, pkw = cf.prepare(plan, params.W_pfb, carry, *x, **kw)
        return cf.channelize_fused_plain(*args, **pkw, out_layout=layout)
    return kernel, plain


def _tail_case(cfg, params, gen, *, device, raw=None, time2d=False,
               tile: int | None = None, n_real: int | None = None):
    """(wrapper call, plain call) of the FIR tail on raw planes (unless
    given: noise, or for NBFM one FM carrier a channel), random history
    and a fresh state; the config's
    AGC hang window when it has one. time2d: the 2-D time-major source,
    float32 planes [nf, C] read as one plane of C columns. tile: the
    tail tile (the peak segment) in place of the config's. Given raw
    planes [n1, nf, n2] set the channel count; channels from n_real on are
    the mesh's phantom rows: zero history and zero state, as the sharded
    wideband pads them."""
    from supersdr_tpu_torch.ops import fir_matmul
    from supersdr_tpu_torch.ops.cuda import chain_tail as ct
    from supersdr_tpu_torch.runtime import chain
    from supersdr_tpu_torch.runtime import wideband as wb
    ccfg = cfg.chain_cfg
    n1, n2 = (1, cfg.n_chan) if time2d else wb._factors_for(cfg)
    if raw is not None and not time2d:
        n1, n2 = raw[0].shape[0], raw[0].shape[2]
    nf, C, ov = ccfg.chunk, n1 * n2, cfg.n_taps - 1
    PER = ccfg.interp_plan.per
    fast = cfg.passband_precision == "default"
    if raw is None:
        if ccfg.mode == "NBFM":
            # FM carriers: on noise the discriminator's angle lies next to
            # its ±π cut in a few samples of a million, where rounding
            # decides the sign
            z = _fm_carriers(C, nf, gen, device).reshape(n1, n2, nf)
            raw = [p.permute(0, 2, 1).contiguous() for p in (z.real, z.imag)]
        else:
            raw = [torch.randn(n1, nf, n2, generator=gen, device=device)
                   * 0.05 for _ in range(2)]
        if fast and not time2d:
            raw = [r.to(torch.bfloat16) for r in raw]
    elif time2d:
        raw = [r[None] for r in raw]
    head = [torch.randn(ov, C, generator=gen, device=device) * 0.05
            for _ in range(2)]
    st = torch.zeros(4 + PER, C, device=device)
    st[2] = -120.0
    if n_real is not None:
        for h in head:
            h[:, n_real:] = 0.0
        st[2, n_real:] = 0.0
    tile = tile or chain._tail_tile(ccfg.chunk, ccfg.n_taps)
    B, n_prev = fir_matmul.tail_fir_block(ccfg.chunk, ccfg.n_taps, tile)
    args = (*raw, *head, st, chain._tail_params_vec(params.chain, ccfg),
            params.chain.W_tailpass, params.chain.P_interp)
    kw = dict(n_taps=cfg.n_taps, B=B, n_prev=n_prev, tile_t=tile,
              demod=chain._tail_demod(ccfg), fir_bf16=fast, rs_bf16=False,
              hang_window=chain._tail_hang_window(ccfg))
    return (lambda: ct.chain_tail_fir(*args, **kw),
            lambda: ct.chain_tail_plain(*args, **kw))


def _fold_case(cfg, params, gen, *, device, nf: int | None = None,
               x=None):
    """(wrapper call, plain call) of the fold on a random carry and a
    random chunk of nf frames (default: the config's) unless x is given;
    outputs as real views of the complex fold."""
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.ops.cuda import pfb_fold as pf
    from supersdr_tpu_torch.runtime import wideband as wb
    plan = wb.pfb_plan(cfg)
    M, K = cfg.n_chan, cfg.taps_per
    n = (nf or cfg.chunk_per_chan) * M
    if x is None:
        x = cx.CX(*(torch.randn(n, generator=gen, device=device) * 0.05
                    for _ in range(2)))
    carry = cx.CX(*(torch.randn(plan.history, generator=gen,
                                device=device) * 0.05 for _ in range(2)))
    G = params.W_pfb.reshape(-1).flip(0).reshape(K, M).contiguous()
    return (lambda: (torch.view_as_real(pf.pfb_fold(plan, G, carry, x)),),
            lambda: (torch.view_as_real(pf.pfb_fold_plain(
                G, carry.re, carry.im, x.re, x.im)),))


def _mesh_chan_case(cfg, params, gen, *, device, D: int = MESH_D,
                    i16: bool = False):
    """(wrapper call, plain call) of the channelizer's mesh form: D time
    shards of the config's chunk, each with a random history head, at the
    factoring the sharded wideband picks for D shards (at 2560 channels and
    8 shards (20, 128) with 24 planes, 4 of them phantom)."""
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.ops.cuda import channelize_fused as cf
    from supersdr_tpu_torch.parallel import sharded_wideband as sw
    from supersdr_tpu_torch.runtime import wideband as wb
    plan = wb.pfb_plan(cfg)
    n1, n2, n1_pad = sw.plan_mesh(cfg, D).factors
    n = cfg.chunk_in // D
    if i16:
        x = tuple((torch.randn(D, n, generator=gen, device=device) * 1600
                   ).round().to(torch.int16) for _ in range(2))
    else:
        x = cx.CX(*(torch.randn(D, n, generator=gen, device=device) * 0.05
                    for _ in range(2)))
    carry = cx.CX(*(torch.randn(D, plan.history, generator=gen,
                                device=device) * 0.05 for _ in range(2)))
    fast = cfg.chan_precision == "default"
    kw = dict(factors=(n1, n2), bf16_mxu=fast,
              out_dtype=torch.bfloat16 if fast else torch.float32)

    def kernel():
        return cf.channelize_fused_c(plan, params.W_pfb, carry, x,
                                     n1_pad=n1_pad, **kw)[1]

    def plain():
        args, pkw = cf.prepare(plan, params.W_pfb, carry, *x, **kw)
        return cf.channelize_fused_plain(*args, **pkw, n1_out=n1_pad)
    return kernel, plain, (n1, n2, n1_pad)


def _mesh_kernel_cases(cfg, params, gen, *, device, err: dict,
                       label: str) -> tuple:
    """The channelizer's mesh form against its plain version (phantom
    planes exactly 0), then the FIR tail on the planes the all_to_all
    makes of its output, [n1_pad, frames, n2], the phantom rows on zero
    history and state: against its plain version, every output finite.
    Returns the (kernel, plain) calls of both, for timing."""
    from supersdr_tpu_torch.parallel import collectives
    prof = "fast" if cfg.chan_precision == "default" else "quality"
    kernel, plain, (n1, n2, n1_pad) = _mesh_chan_case(cfg, params, gen,
                                                      device=device)
    _compare("channelize_fused", f"{label} {prof} mesh D={MESH_D} "
             f"({n1}, {n2}) n1_out={n1_pad}", kernel, plain,
             TOL_SNR_DB["chan_" + prof], device, err)
    out = kernel()
    phantom = max(float(p[:, n1:].float().abs().max()) for p in out)
    print(f"kernel channelize_fused {label} {prof} mesh: phantom planes "
          f"max |x| {phantom}", flush=True)
    if phantom != 0.0:
        raise AssertionError("the channelizer's phantom planes are not 0")
    raw = [collectives.all_to_all(p, 0, 1).reshape(n1_pad, -1, n2)
           for p in out]
    del out
    tk, tp = _tail_case(cfg, params, gen, device=device, raw=raw,
                        n_real=cfg.n_chan)
    _compare("chain_tail", f"{label} {prof} mesh [{n1_pad}, "
             f"{raw[0].shape[1]}, {n2}] planes", tk, tp, TOL_SNR_DB["tail"],
             device, err)
    got = tk()
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError("the FIR tail is not finite on the phantom "
                             "rows")
    return (kernel, plain), (tk, tp)


def _fm_carriers(C: int, nf: int, gen, device) -> torch.Tensor:
    """[C, nf] complex: one Carson-safe FM carrier a channel over noise."""
    t = torch.arange(nf, device=device, dtype=torch.float64) / 12_000.0
    g = 300.0 + 700.0 * torch.rand(C, 1, generator=gen, device=device,
                                   dtype=torch.float64)
    beta = 1.0 + 1.5 * torch.rand(C, 1, generator=gen, device=device,
                                  dtype=torch.float64)
    ph = beta * torch.sin(2 * np.pi * g * t)
    z = 0.4 * torch.exp(1j * ph) + 0.01 * torch.randn(
        C, nf, generator=gen, device=device, dtype=torch.complex128)
    return z.to(torch.complex64)


def _am_case(C: int, nf: int, gen, *, device, mode: str = "AM",
             agc: dict | None = None, hang_ms: float | None = None,
             accum: bool = False, y=None, yT=None, n_taps: int = 257,
             tile: int | None = None):
    """(wrapper call, plain call) of the non-FIR tail on a fresh state.
    On y [C, nf] (chain-major complex, random noise or FM carriers unless
    given) handed over as the complex tensor itself (`chain_tail_am_c`)
    and written chain-major, as the chain's tail tier runs it. With yT, a
    (re, im) pair of contiguous time-major planes [nf, C]: read as they
    lie and written time-major with the power row, as the time-major
    wideband tier runs it. tile: the tail tile (the peak segment) in place
    of the chunk's."""
    from supersdr_tpu_torch.ops.cuda import chain_tail as ct
    from supersdr_tpu_torch.runtime import chain
    ccfg = chain.ChainConfig(mode=mode, chunk=nf, os_block=nf,
                             n_taps=n_taps, hang_enabled=hang_ms is not None,
                             hang_ms=hang_ms or 500.0)
    params = chain.make_params(ccfg, agc_kwargs=dict(
        agc or {}, hang=hang_ms is not None), device=device)
    if y is None and yT is None:
        y = (_fm_carriers(C, nf, gen, device) if mode == "NBFM" else
             torch.randn(C, nf, generator=gen, device=device,
                         dtype=torch.complex64) * 0.05)
    st = chain._state_rows(ccfg, chain.init_state(ccfg, (C,), device=device))
    planes = (y.real.T, y.imag.T) if yT is None else tuple(yT)
    rest = (st, chain._tail_params_vec(params, ccfg), params.P_interp)
    kw = dict(tile_t=tile or chain._tail_tile(nf, n_taps),
              demod=chain._tail_demod(ccfg),
              accum_pow=accum or yT is not None,
              hang_window=chain._tail_hang_window(ccfg))
    lay = dict(audio_layout="chan" if yT is None else "time")
    plain = (lambda: ct.chain_tail_am_plain(*planes, *rest, **kw, **lay))
    if yT is None:
        return lambda: ct.chain_tail_am_c(y, *rest, **kw), plain
    return lambda: ct.chain_tail_am(*planes, *rest, **kw, **lay), plain


def _compare(name: str, label: str, kernel, plain, tol: float, device,
             err: dict) -> None:
    """Run a kernel and its plain version on the same inputs; every output
    must reach `tol` dB SNR against the plain one. Records the largest
    absolute error in err[name]."""
    ref, got = plain(), kernel()
    _sync(device)
    snrs = [_snr_db(r.float(), g.float()) for r, g in zip(ref, got)]
    mx = max(float((r.float() - g.float()).abs().max())
             for r, g in zip(ref, got))
    err[name] = max(err.get(name, 0.0), mx)
    print(f"kernel {name} {label}: snr {' / '.join(f'{s:.2f}' for s in snrs)}"
          f" dB, max_abs_err {mx:.3e} (tol {tol} dB)", flush=True)
    if not min(snrs) >= tol:
        raise AssertionError(f"{name} {label} disagrees with its plain "
                             f"version")


# (profile, mode, AGC settings); USB has complex taps
TAIL_CASES = (("fast", "AM", None), ("quality", "AM", None),
              ("fast", "USB", None), ("quality", "USB", None),
              ("fast", "NBFM", dict(on=False)),
              ("quality", "NBFM", dict(on=False)))


def phase_kernels(shape: dict, device, err: dict, seed: int = 7) -> None:
    """Each kernel's wrapper against its plain version on the same inputs:
    the channelizer on both tiers with f32 and i16 input, and with a
    ragged last block of frames (13 frames); the FIR tail on AM (both
    tiers), USB, NBFM and AM with hang, and with a ragged last time tile
    (640 frames); the fold, also on 13 frames; the non-FIR tail on AM with
    hang off and on (500 and 40 ms), USB, NBFM on FM carriers with manual
    AGC, with the power row, on 640 frames, and on time-major planes with
    time-major audio (AM, USB with hang). Also the channelizer's time-major
    store (on the config's frames and on 24, float32 and int16 input) and
    the FIR tail's 2-D time-major source, both tiers; the channelizer on
    other factorings of the channel count; USB (complex taps)
    and NBFM on both tiers' FIR; and peak segments shorter than, as long
    as and longer than the tails' 256-sample scan piece, with the hang."""
    from supersdr_tpu_torch.runtime import wideband as wb
    gen = torch.Generator(device=device).manual_seed(seed)
    for prof in ("fast", "quality"):
        cfg = wb.WidebandConfig(**shape, **wb.PROFILES[prof])
        params = wb.make_params(cfg, device=device)
        for i16, nf, layout in ((False, None, "raw3"), (True, None, "raw3"),
                                (False, 13, "raw3"), (False, None, "time"),
                                (False, 24, "time"), (True, None, "time"),
                                (True, 24, "time")):
            label = (f"{prof} {'i16' if i16 else 'f32'} {layout} "
                     f"nf={nf or cfg.chunk_per_chan}")
            _compare("channelize_fused", label,
                     *_chan_case(cfg, params, gen, i16=i16, device=device,
                                 nf=nf, layout=layout),
                     TOL_SNR_DB["chan_" + prof], device, err)
        _compare("chain_tail", f"{prof} AM 2-D source "
                 f"nf={cfg.chunk_per_chan}",
                 *_tail_case(cfg, params, gen, device=device, time2d=True),
                 TOL_SNR_DB["tail"], device, err)
        # other factorings of the channel count: 2 × 256 (one row tile),
        # 12 × 256 (stage-A outputs and row tiles in two passes, 4-frame
        # blocks for the time store), 5 × 512 (two column blocks)
        for n_chan, factors in ((512, None), (3072, None), (2560, (5, 512))):
            fcfg = wb.WidebandConfig(**dict(
                shape, n_chan=n_chan, fs_in=n_chan * 12_000,
                chunk_in=n_chan * 40, chan_factors=factors),
                **wb.PROFILES[prof])
            fparams = wb.make_params(fcfg, device=device)
            for i16, layout in ((False, "raw3"), (True, "time")):
                n1, n2 = wb._factors_for(fcfg)
                _compare("channelize_fused",
                         f"{prof} {'i16' if i16 else 'f32'} {layout} "
                         f"{n1} x {n2} channels nf=40",
                         *_chan_case(fcfg, fparams, gen, i16=i16,
                                     device=device, layout=layout),
                         TOL_SNR_DB["chan_" + prof], device, err)
        # the mesh form: 8 time shards, (20, 128) with 4 phantom planes,
        # float32 and int16 input; the FIR tail on the resharded planes
        _mesh_kernel_cases(cfg, params, gen, device=device, err=err,
                           label="MID")
        k16, p16, _ = _mesh_chan_case(cfg, params, gen, device=device,
                                      i16=True)
        _compare("channelize_fused", f"MID {prof} mesh D={MESH_D} i16", k16,
                 p16, TOL_SNR_DB["chan_" + prof], device, err)
    ragged = dict(shape, chunk_in=shape["n_chan"] * 640)
    cases = [(shape, c) for c in TAIL_CASES] + [
        (ragged, ("fast", "AM", None)), (ragged, ("quality", "USB", None))]
    cases.append((shape, ("quality", "AM hang 500 ms", dict(hang=True))))
    # peak segments as long as the kernel's 256-sample scan piece and, on a
    # 129-tap passband, shorter (the configs' own are longer)
    short = dict(shape, n_taps=129)
    cases += [(shape, ("fast", "AM hang 500 ms seg 256", dict(hang=True))),
              (shape, ("quality", "USB seg 256", None)),
              (short, ("fast", "USB hang 500 ms seg 128", dict(hang=True))),
              (short, ("quality", "AM seg 128", None))]
    for shp, (prof, mode, agc) in cases:
        hang = "hang" in mode
        tile = int(mode.split()[-1]) if "seg" in mode else None
        cfg = wb.WidebandConfig(**dict(shp, mode=mode.split()[0],
                                       hang_enabled=hang),
                                **wb.PROFILES[prof])
        params = wb.make_params(cfg, device=device, agc_kwargs=agc)
        _compare("chain_tail", f"{prof} {mode} nf={cfg.chunk_per_chan}",
                 *_tail_case(cfg, params, gen, device=device, tile=tile),
                 TOL_SNR_DB["tail"], device, err)
    # a 601-tap passband (a 608-row history over 256-row tiles) on 1280
    # frames, whose tail tile (640) holds the FIR block: the quality tier's
    # planes and the 2-D source (float32 rows) on both tiers
    long = dict(shape, n_taps=601, chunk_in=shape["n_chan"] * 1280)
    for prof, time2d in (("quality", False), ("fast", True),
                         ("quality", True)):
        cfg = wb.WidebandConfig(**long, **wb.PROFILES[prof])
        params = wb.make_params(cfg, device=device)
        src = "2-D source" if time2d else "planes"
        _compare("chain_tail", f"{prof} AM 601 taps {src} "
                 f"nf={cfg.chunk_per_chan}",
                 *_tail_case(cfg, params, gen, device=device,
                             time2d=time2d),
                 TOL_SNR_DB["tail"], device, err)
        _tail_launch_info("chain_tail", f"{prof} AM 601 taps {src}",
                          cfg.n_chan, cfg.chain_cfg,
                          (prof == "fast") << 3)
    # 10 planes of 40 channels: 50 blocks, a block count that is no multiple
    # of 4, 400 channels that are no multiple of 32
    for prof in ("fast", "quality"):
        cfg = wb.WidebandConfig(**shape, **wb.PROFILES[prof])
        params = wb.make_params(cfg, device=device)
        raw = [torch.randn(10, cfg.chunk_per_chan, 40, generator=gen,
                           device=device) * 0.05 for _ in range(2)]
        if prof == "fast":
            raw = [r.to(torch.bfloat16) for r in raw]
        _compare("chain_tail", f"{prof} AM [10, {cfg.chunk_per_chan}, 40] "
                 f"planes", *_tail_case(cfg, params, gen, device=device,
                                        raw=raw),
                 TOL_SNR_DB["tail"], device, err)
    cfg = wb.WidebandConfig(**shape, **CHANMAJOR)
    params = wb.make_params(cfg, device=device)
    for nf in (None, 13):
        _compare("pfb_fold", f"nf={nf or cfg.chunk_per_chan}",
                 *_fold_case(cfg, params, gen, device=device, nf=nf),
                 TOL_SNR_DB["fold"], device, err)
    C, nf = shape["n_chan"], shape["chunk_in"] // shape["n_chan"]
    for label, kw in (("AM", {}), ("AM hang 500 ms", dict(hang_ms=500.0)),
                      ("AM hang 40 ms", dict(hang_ms=40.0)),
                      ("USB", dict(mode="USB")),
                      ("NBFM manual AGC", dict(mode="NBFM",
                                               agc=dict(on=False))),
                      ("AM power row", dict(accum=True)),
                      ("USB hang 40 ms", dict(mode="USB", hang_ms=40.0,
                                              nf=640)),
                      ("AM hang 40 ms seg 64", dict(hang_ms=40.0, tile=64)),
                      ("USB seg 64", dict(mode="USB", tile=64)),
                      ("AM hang 500 ms seg 256", dict(hang_ms=500.0,
                                                      tile=256)),
                      ("NBFM manual AGC seg 128", dict(
                          mode="NBFM", agc=dict(on=False), tile=128,
                          nf=640))):
        kw = dict(kw)
        n = kw.pop("nf", nf)
        _compare("chain_tail_am_c", f"{label} nf={n}",
                 *_am_case(C, n, gen, device=device, **kw),
                 TOL_SNR_DB["tail"], device, err)
    # channel counts that leave the last block of 2 channels (and of 8)
    # ragged
    for label, kw, n_ch in (("AM hang 40 ms", dict(hang_ms=40.0), C - 13),
                            ("USB", dict(mode="USB"), C - 12)):
        _compare("chain_tail_am_c", f"{label} nf={nf}, {n_ch} channels",
                 *_am_case(n_ch, nf, gen, device=device, **kw),
                 TOL_SNR_DB["tail"], device, err)
    _am_refusals(C, nf, gen, device)
    # time-major audio launches clusters of four blocks: also channel
    # counts that leave the last block ragged and the last cluster short
    # (C − 12: 319 blocks; 40: 5 blocks, one in the last cluster)
    for label, kw, n_ch in (("AM", {}, C),
                            ("USB hang 40 ms", dict(mode="USB", hang_ms=40.0),
                             C),
                            ("AM", {}, C - 12),
                            ("AM hang 40 ms", dict(hang_ms=40.0), 40)):
        yT = [torch.randn(nf, n_ch, generator=gen, device=device) * 0.05
              for _ in range(2)]
        _compare("chain_tail_am",
                 f"{label} time-major nf={nf}, {n_ch} channels",
                 *_am_case(n_ch, nf, gen, device=device, yT=yT, **kw),
                 TOL_SNR_DB["tail"], device, err)


def _am_refusals(C: int, nf: int, gen, device) -> None:
    """On the card the non-FIR wrappers refuse what their kernels do not
    read or write: rows at an odd element offset (not 16-byte aligned) for
    the complex entry, chain-major audio for the planes' entry."""
    from supersdr_tpu_torch.ops.cuda import chain_tail as ct
    y = torch.randn(C, nf + 1, generator=gen, device=device,
                    dtype=torch.complex64) * 0.05
    kernel, _ = _am_case(C, nf, gen, device=device, y=y[:, 1:])
    planes = (y.real.T[:nf], y.imag.T[:nf])
    st = torch.zeros(4 + 9, C, device=device)
    par = torch.zeros(9, device=device)
    P = torch.zeros(9, 4, device=device)
    calls = {"odd offset": kernel,
             "chain-major audio": lambda: ct.chain_tail_am(
                 *planes, st, par, P, tile_t=nf, demod="am",
                 audio_layout="chan")}
    for label, call in calls.items():
        before = (ct.chain_tail_am.launches, ct.chain_tail_am_c.launches)
        try:
            call()
        except ValueError as e:
            print(f"kernel chain_tail_am refuses {label}: {e}", flush=True)
        else:
            raise AssertionError(f"chain_tail_am took {label}")
        if (ct.chain_tail_am.launches, ct.chain_tail_am_c.launches) \
                != before:
            raise AssertionError(f"chain_tail_am launched on {label}")


def _wrappers() -> dict:
    """Each kernel's wrapper by its name in the JSON summary."""
    from supersdr_tpu_torch.ops import cuda
    return cuda.counted()


def _reset_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def _counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def _headline_inputs(cfg, gen, device):
    n = cfg.chunk_in
    from supersdr_tpu_torch.ops import cx
    f32 = [cx.CX(*(torch.randn(n, generator=gen, device=device) * 0.05
                   for _ in range(2))) for _ in range(2)]
    i16 = [tuple((torch.randn(n, generator=gen, device=device) * 1600
                  ).round().to(torch.int16) for _ in range(2))
           for _ in range(2)]
    return f32, i16


def phase_main_path(shape: dict, device, seed: int = 1) -> dict:
    """process_n on both profiles with f32 and i16 chunks; launch counts
    and audio checks."""
    from supersdr_tpu_torch.ops.cuda import chain_tail as ct
    from supersdr_tpu_torch.ops.cuda import channelize_fused as cf
    from supersdr_tpu_torch.runtime import wideband as wb
    gen = torch.Generator(device=device).manual_seed(seed)
    runs = {}
    for prof in ("fast", "quality"):
        cfg = wb.WidebandConfig(**shape, **wb.PROFILES[prof])
        runs[prof] = (cfg, wb.make_params(cfg, device=device),
                      *_headline_inputs(cfg, gen, device))
    L = 4
    _reset_counts()
    for prof, (cfg, params, f32, i16) in runs.items():
        for kind, chunks in (("f32", f32), ("i16", i16)):
            before = (cf.channelize_fused_raw3.launches,
                      ct.chain_tail_fir.launches)
            _, outs = wb.process_n(cfg, params, wb.init_state(
                cfg, device=device), chunks)
            _sync(device)
            grew = (cf.channelize_fused_raw3.launches - before[0],
                    ct.chain_tail_fir.launches - before[1])
            shape_ok = all(tuple(a.shape) == (cfg.chunk_per_chan * L,
                                              cfg.n_chan) for a in outs)
            finite = all(bool(torch.isfinite(a).all()) for a in outs)
            mean_abs = [float(a.abs().mean()) for a in outs]
            print(f"main path {prof} {kind}: launches/chunk "
                  f"{grew[0] / len(chunks):g}, {grew[1] / len(chunks):g}; "
                  f"audio {tuple(outs[0].shape)} finite={finite} "
                  f"mean|a|={mean_abs}", flush=True)
            if grew != (len(chunks), len(chunks)) or not shape_ok \
                    or not finite or min(mean_abs) <= 0:
                raise AssertionError(f"main path {prof} {kind} failed")
    launches = _counts()
    if launches["pfb_fold"] or launches["chain_tail_am"] \
            or launches["chain_tail_am_c"] or launches["halo"]:
        raise AssertionError(f"planar main path ran another tier: {launches}")
    return {"launches": launches, "runs": runs}


def phase_timing(runs: dict, err: dict, iters: int = 5,
                 seed: int = 3) -> dict:
    """ms a chunk of process_n (2 chunks a call, ending on a device-side
    reduction of the audio); then, at the same HEADLINE shapes, each
    kernel's wrapper against its plain version, and both timed. The tail
    reads the channelizer kernel's raw planes."""
    from supersdr_tpu_torch.runtime import wideband as wb
    times = {}
    for prof, (cfg, params, f32, i16) in runs.items():
        dev = f32[0].re.device
        for kind, chunks in (("f32", f32), ("i16", i16)):
            st = [wb.init_state(cfg, device=dev)]

            def step():
                st[0], outs = wb.process_n(cfg, params, st[0], chunks)
                return outs[-1].abs().mean()
            ms = cuda_ms(step, iters) / len(chunks)
            rate = cfg.chunk_in / (ms * 1e-3) / 1e6
            print(f"time main path {prof} {kind}: {ms:.3f} ms/chunk, "
                  f"{rate:.1f} Msamples/s input", flush=True)
            times[f"main_{prof}_{kind}"] = ms
            if kind == "f32":
                device_share(f"planar {prof} f32 ({len(chunks)} chunks a "
                             f"call)", step, calls=3, rows=6)
        gen = torch.Generator(device=dev).manual_seed(seed)
        label = f"{prof} nf={cfg.chunk_per_chan}"
        kernel, plain = _chan_case(cfg, params, gen, i16=False, device=dev)
        _compare("channelize_fused", label, kernel, plain,
                 TOL_SNR_DB["chan_" + prof], dev, err)
        times[f"channelize_fused_{prof}"] = (cuda_ms(kernel, iters),
                                             cuda_ms(plain, 2))
        raw = kernel()
        k16, p16 = _chan_case(cfg, params, gen, i16=True, device=dev)
        _compare("channelize_fused", f"{label} i16", k16, p16,
                 TOL_SNR_DB["chan_" + prof], dev, err)
        times[f"channelize_fused_i16_{prof}"] = (cuda_ms(k16, iters),
                                                 cuda_ms(p16, 2))
        del k16, p16
        kernel, plain = _tail_case(cfg, params, gen, device=dev, raw=raw)
        _compare("chain_tail", f"{label} AM", kernel, plain,
                 TOL_SNR_DB["tail"], dev, err)
        times[f"chain_tail_{prof}"] = (cuda_ms(kernel, iters),
                                       cuda_ms(plain, 2))
        for name in ("channelize_fused", "channelize_fused_i16",
                     "chain_tail"):
            k_ms, p_ms = times[f"{name}_{prof}"]
            print(f"time {name} {prof}: kernel {k_ms:.3f} ms, "
                  f"plain {p_ms:.3f} ms", flush=True)
        if prof == "fast":
            _chan_launch_info(cfg)
            _fir_launch_info(cfg, "HEADLINE", cfg.n_chan)
            _tail_launch_info("chain_tail", "mesh [24, ·, 128] planes fast "
                              "AM", 24 * 128, cfg.chain_cfg, 3 << 3)
        # the other demodulators through the scanned body at this length,
        # USB on complex taps, and AM with the hang
        for mode, agc, hang in (("USB", None, False),
                                ("NBFM", dict(on=False), False),
                                ("AM", dict(hang=True), True)):
            mcfg = wb.WidebandConfig(**dict(
                HEADLINE, chunk_in=cfg.chunk_in, mode=mode,
                hang_enabled=hang), **wb.PROFILES[prof])
            mparams = wb.make_params(mcfg, device=dev, agc_kwargs=agc)
            kernel, plain = _tail_case(mcfg, mparams, gen, device=dev,
                                       raw=None if mode == "NBFM" else raw)
            what = f"{mode} hang 500 ms" if hang else mode
            _compare("chain_tail", f"{label} {what}", kernel, plain,
                     TOL_SNR_DB["tail"], dev, err)
            print(f"time chain_tail {prof} {what}: kernel "
                  f"{cuda_ms(kernel, iters):.3f} ms", flush=True)
        del raw, kernel, plain
    return times


def phase_chanmajor(shape: dict, device, seed: int = 2) -> dict:
    """The chan-major main path (CHANMAJOR) through process_n, 2 float32
    chunks made on the card: one fold and one non-FIR tail launch a chunk,
    no other kernel; audio [n_chan, frames·4], finite and non-zero."""
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.runtime import wideband as wb
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = wb.WidebandConfig(**shape, **CHANMAJOR)
    params = wb.make_params(cfg, device=device)
    n = cfg.chunk_in
    chunks = [cx.CX(*(torch.randn(n, generator=gen, device=device) * 0.05
                      for _ in range(2))) for _ in range(2)]
    _reset_counts()
    _, outs = wb.process_n(cfg, params, wb.init_state(cfg, device=device),
                           chunks)
    _sync(device)
    launches = _counts()
    shape_ok = all(tuple(a.shape) == (cfg.n_chan, cfg.chunk_per_chan * 4)
                   for a in outs)
    finite = all(bool(torch.isfinite(a).all()) for a in outs)
    mean_abs = [float(a.abs().mean()) for a in outs]
    print(f"main path chanmajor f32: launches {launches} for "
          f"{len(chunks)} chunks; audio {tuple(outs[0].shape)} "
          f"finite={finite} mean|a|={mean_abs}", flush=True)
    want = {"channelize_fused": 0, "chain_tail": 0, "pfb_fold": len(chunks),
            "chain_tail_am": 0, "chain_tail_am_c": len(chunks), "halo": 0,
            "squelch_gate": 0}
    if launches != want or not shape_ok or not finite or min(mean_abs) <= 0:
        raise AssertionError("chan-major main path failed")
    return {"launches": launches, "cfg": cfg, "params": params,
            "chunks": chunks}


def phase_chanmajor_timing(run: dict, err: dict, iters: int = 5,
                           seed: int = 4) -> dict:
    """ms a chunk of the chan-major process_n; each new kernel against and
    beside its plain version at HEADLINE (the fold on a chunk, the tail on
    the chunk's passband y); then where the device time goes
    (torch.profiler over two process_n calls, after a warm-up one)."""
    from supersdr_tpu_torch.runtime import wideband as wb
    cfg, params, chunks = run["cfg"], run["params"], run["chunks"]
    dev = chunks[0].re.device
    st = [wb.init_state(cfg, device=dev)]

    def step():
        st[0], outs = wb.process_n(cfg, params, st[0], chunks)
        return outs[-1].abs().mean()
    ms = cuda_ms(step, iters) / len(chunks)
    print(f"time main path chanmajor f32: {ms:.3f} ms/chunk, "
          f"{cfg.chunk_in / (ms * 1e-3) / 1e6:.1f} Msamples/s input",
          flush=True)
    times = {"main_chanmajor_f32": ms}
    gen = torch.Generator(device=dev).manual_seed(seed)
    kernel, plain = _fold_case(cfg, params, gen, device=dev, x=chunks[0])
    _compare("pfb_fold", f"nf={cfg.chunk_per_chan}", kernel, plain,
             TOL_SNR_DB["fold"], dev, err)
    times["pfb_fold"] = (cuda_ms(kernel, iters), cuda_ms(plain, 2))
    _, out = wb.process(cfg, params, wb.init_state(cfg, device=dev),
                        chunks[0])
    y = torch.complex(out.baseband.re, out.baseband.im)       # [C, nf]
    kernel, plain = _am_case(cfg.n_chan, cfg.chunk_per_chan, gen,
                             device=dev, y=y)
    _compare("chain_tail_am_c", f"AM nf={cfg.chunk_per_chan}", kernel,
             plain, TOL_SNR_DB["tail"], dev, err)
    times["chain_tail_am_c"] = (cuda_ms(kernel, iters), cuda_ms(plain, 2))
    for name in ("pfb_fold", "chain_tail_am_c"):
        print(f"time {name}: kernel {times[name][0]:.3f} ms, "
              f"plain {times[name][1]:.3f} ms", flush=True)
    _tail_launch_info("chain_tail_am_c", "chanmajor", cfg.n_chan,
                      cfg.chain_cfg)
    # the other demodulators through the scanned body at this length (NBFM
    # on FM carriers with manual AGC), and AM with the hang
    for label, kw in (("USB", dict(mode="USB", y=y)),
                      ("NBFM manual AGC", dict(mode="NBFM",
                                               agc=dict(on=False))),
                      ("AM hang 500 ms", dict(hang_ms=500.0, y=y)),
                      ("AM hang 40 ms", dict(hang_ms=40.0, y=y))):
        kernel, plain = _am_case(cfg.n_chan, cfg.chunk_per_chan, gen,
                                 device=dev, **kw)
        _compare("chain_tail_am_c", f"{label} nf={cfg.chunk_per_chan}",
                 kernel, plain, TOL_SNR_DB["tail"], dev, err)
        print(f"time chain_tail_am_c {label}: kernel "
              f"{cuda_ms(kernel, iters):.3f} ms", flush=True)
    del y, out, kernel, plain
    device_share(f"chanmajor f32 ({len(chunks)} chunks a call)", step,
                 calls=3, rows=12)
    return times


def phase_rows(shape: dict, device, tier: dict | None = None,
               rows=(7, 1300), seed: int = 31) -> None:
    """AM carriers at channel_freqs(cfg)[r] must be the loudest RSSI rows
    (planar fast profile unless another tier is given)."""
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.runtime import wideband as wb
    cfg = wb.WidebandConfig(**shape, **(tier or wb.PROFILES["fast"]))
    params = wb.make_params(cfg, device=device)
    st = wb.init_state(cfg, device=device)
    freqs = wb.channel_freqs(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = cfg.chunk_in
    for k in range(2):
        t = (torch.arange(n, device=device, dtype=torch.float64)
             + k * n) / cfg.fs_in
        z_r = 0.02 * torch.randn(n, generator=gen, device=device,
                                 dtype=torch.float64)
        z_i = 0.02 * torch.randn(n, generator=gen, device=device,
                                 dtype=torch.float64)
        for r in rows:
            amp = 0.5 * (1 + 0.5 * torch.sin(2 * np.pi * 700 * t))
            ph = 2 * np.pi * torch.remainder(freqs[r] * t, 1.0)
            z_r = z_r + amp * torch.cos(ph)
            z_i = z_i + amp * torch.sin(ph)
        st, out = wb.process(cfg, params, st, cx.CX(z_r.float(),
                                                    z_i.float()))
    rssi = out.rssi[:, -1]
    top = sorted(int(i) for i in torch.argsort(rssi, descending=True)[:2])
    label = "planar" if cfg.time_major else "chanmajor"
    print(f"rows {label}: loudest RSSI rows {top} "
          f"({[round(float(rssi[i]), 2) for i in top]} dB), "
          f"carriers at rows {sorted(rows)}", flush=True)
    if top != sorted(rows):
        raise AssertionError("row alignment failed")


def phase_controls(shape: dict, device, seed: int = 5) -> dict:
    """AGC hang and squelch on the planar HEADLINE path (fast profile): one
    run each, one channelizer and one FIR-tail launch a chunk as without
    them, and with the squelch one gate launch a chunk; the squelch must
    close on a quiet chunk after a loud one. Returns the squelch run's
    launches."""
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.runtime import wideband as wb
    gen = torch.Generator(device=device).manual_seed(seed)
    n = shape["chunk_in"]
    chunks = [cx.CX(*(torch.randn(n, generator=gen, device=device) * lvl
                      for _ in range(2))) for lvl in (0.05, 0.005, 0.005)]
    for label, extra, pkw in (
            ("hang", dict(hang_enabled=True),
             dict(agc_kwargs=dict(hang=True))),
            ("squelch", dict(squelch_enabled=True),
             dict(squelch_kwargs=dict(enabled=True, thresh_db=-75.0)))):
        cfg = wb.WidebandConfig(**shape, **extra, **wb.PROFILES["fast"])
        params = wb.make_params(cfg, device=device, **pkw)
        _reset_counts()
        st, outs = wb.process_n(cfg, params, wb.init_state(cfg, device=device),
                                chunks)
        _sync(device)
        launches = _counts()
        finite = all(bool(torch.isfinite(a).all()) for a in outs)
        opened = float(st.chain.squelch.open_.mean())
        print(f"controls {label}: launches {launches} for {len(chunks)} "
              f"chunks; finite={finite}; squelch open share {opened:.3f}",
              flush=True)
        want = {"channelize_fused": len(chunks), "chain_tail": len(chunks),
                "pfb_fold": 0, "chain_tail_am": 0, "chain_tail_am_c": 0,
                "halo": 0, "squelch_gate": len(chunks) * (label == "squelch")}
        if launches != want or not finite \
                or (label == "squelch" and opened != 0.0):
            raise AssertionError(f"planar {label} failed")
    return {"launches": launches}


# what the squelch cell's gates meet a HEADLINE chunk (keyed carriers):
# channels settled open, settled shut; the rest of the 2560 move
SQUELCH_MIX = (159, 2351)


def _squelch_case(C: int, n: int, gen, *, device, dtype=torch.float32,
                  with_order: bool = True):
    """The squelch gate on time-major audio [n, C] of `dtype` with the
    squelch cell's mix of channels (SQUELCH_MIX scaled to C; the moving
    ones opening from 0, closing from 1 and mid-ramp), its thresholds and
    ramp at the audio rate, the state in bin order behind a random row
    order (no order with `with_order` False). Returns (kernel, plain, work,
    src, (settled open, settled shut, moving)): kernel() gates `work` in
    place (copy `src` into it for a fresh call), plain() gates `src` into a
    new tensor; both return (audio, open', gain')."""
    from supersdr_tpu_torch.ops import squelch as sq
    from supersdr_tpu_torch.ops.cuda import squelch_gate as sg
    sp = sq.make_squelch(enabled=True, thresh_db=-69.0, hyst_db=6.0,
                         ramp_samples=240, device=device)
    params = sp._replace(ramp=sp.ramp / 4.0)
    n_open = round(SQUELCH_MIX[0] * C / 2560)
    n_shut = round(SQUELCH_MIX[1] * C / 2560)
    cls = torch.randperm(C, generator=gen, device=device)
    kind = torch.full((C,), 2, device=device)          # moving
    kind[cls[:n_open]] = 0
    kind[cls[n_open:n_open + n_shut]] = 1
    third = torch.randint(0, 3, (C,), generator=gen, device=device)
    rnd = torch.rand(C, generator=gen, device=device)
    # settled open: open, gain 1, loud; settled shut: shut, gain 0, quiet;
    # moving: opening (shut, gain 0, loud), closing (open, gain 1, quiet)
    # or mid-ramp (open, a gain inside (0, 1), between the thresholds)
    opening, closing, mid = (kind == 2) & (third == 0), \
        (kind == 2) & (third == 1), (kind == 2) & (third == 2)
    open_row = ((kind == 0) | closing | mid).float()
    gain_row = torch.where(mid, rnd, open_row)
    rssi = torch.where((kind == 0) | opening,
                       torch.full_like(rnd, -60.0),
                       torch.where(mid, torch.full_like(rnd, -72.0),
                                   torch.full_like(rnd, -90.0)))
    order = torch.randperm(C, generator=gen, device=device) \
        if with_order else None
    state = sq.SquelchState(*(
        v if order is None else torch.empty_like(v).index_put_((order,), v)
        for v in (open_row, gain_row)))
    src = (torch.randn(n, C, generator=gen, device=device) * 0.05).to(dtype)
    work = src.clone()

    def kernel():
        st, out = sg.squelch_gate_tmajor(params, state, work, rssi, order)
        return out, st.open_, st.gain

    def plain():
        st, out = sg.squelch_gate_tmajor_plain(params, state, src, rssi,
                                               order)
        return out, st.open_, st.gain
    counts = (n_open, n_shut, C - n_open - n_shut)
    return kernel, plain, work, src, counts


def cell_conf(name: str) -> dict:
    """A cell's configuration (`sdrbench/configs/<name>.json`)."""
    with open(f"sdrbench/configs/{name}.json") as f:
        return json.load(f)


def cell_bound(kernel: str, conf: dict, frames: int) -> tuple[float, str]:
    """A kernel's least ms on a chunk of `frames` frames as the cells count
    it (`sdrbench/roofline/<kernel>.py` on the configuration `conf`), and
    what bounds it: "bytes" or "operations"."""
    from sdrbench import roofline
    n_bytes, flops = roofline.kernel(kernel).counts(conf, frames)
    t_bytes, t_ops = roofline.least_s(n_bytes, 0.0), roofline.least_s(0.0,
                                                                      flops)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def squelch_bound(counts: tuple, frames: int, esz: int) -> float:
    """The gate's least ms at its boundary, as the squelch cell counts it
    (`sdrbench/roofline/squelch.py`), on audio of `esz` bytes a sample."""
    from sdrbench import roofline
    from sdrbench.roofline import squelch
    conf = cell_conf("hf2560_am_squelch")
    conf["precision"]["audio"] = {4: "f32", 2: "bf16"}[esz]
    return roofline.least_s(*squelch.counts(conf, frames, *counts)) * 1e3


def phase_squelch(device, err: dict, iters: int = 20, seed: int = 26
                  ) -> dict:
    """The squelch gate kernel against its plain version at HEADLINE's
    audio [64512, 2560] on float32, float16 and bfloat16 audio, the squelch
    cell's mix of channels: audio and state equal up to the sign of zero
    (a shut channel's −0.0), one launch a call; ms beside the plain
    version's and the bound."""
    from supersdr_tpu_torch.ops.cuda import squelch_gate as sg
    from supersdr_tpu_torch.runtime import wideband as wb
    cfg = wb.WidebandConfig(**HEADLINE, **wb.PROFILES["fast"])
    n, C = cfg.chunk_per_chan * cfg.chain_cfg.upsample, cfg.n_chan
    gen = torch.Generator(device=device).manual_seed(seed)
    times = {}
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype)[6:]
        kernel, plain, work, src, counts = _squelch_case(
            C, n, gen, device=device, dtype=dtype)
        ref = plain()
        before = sg.squelch_gate_tmajor.launches
        got = kernel()
        _sync(device)
        launched = sg.squelch_gate_tmajor.launches - before
        same = [bool(torch.equal(r, g)) for r, g in zip(ref, got)]
        diff = int((ref[0] != got[0]).sum())
        signs = int(((ref[0] == 0) & (torch.signbit(ref[0])
                                      != torch.signbit(got[0]))).sum())
        mx = max(float((r.float() - g.float()).abs().max())
                 for r, g in zip(ref, got))
        err["squelch_gate"] = max(err.get("squelch_gate", 0.0), mx)
        ms = cuda_ms(kernel, iters)
        plain_ms = cuda_ms(plain, 3)
        bound = squelch_bound(counts, cfg.chunk_per_chan, src.element_size())
        times[f"squelch_gate_{name}"] = (ms, plain_ms, bound)
        print(f"kernel squelch_gate {name} [{n}, {C}] (settled open / shut "
              f"/ moving {counts}): equal to plain up to the sign of zero "
              f"{same} (audio, open, gain), {diff} elements differ, {signs} "
              f"zeros of the other sign, max_abs_err {mx:.3e}; launches "
              f"{launched}; {ms:.4f} ms against {bound:.4f} ms (bytes; "
              f"{100 * bound / ms:.1f} %), plain "
              f"{plain_ms:.3f} ms", flush=True)
        if not all(same) or diff or launched != 1:
            raise AssertionError(f"squelch_gate {name} disagrees with its "
                                 f"plain version")
        del kernel, plain, work, src, ref, got
        torch.cuda.empty_cache()
    # rows the kernel reads one lane at a time (C not a multiple of its
    # 16-byte vector), and no row order
    for C_small, with_order in ((37, True), (40, False), (2560, False)):
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            kernel, plain, *_ = _squelch_case(
                C_small, 4000, gen, device=device, dtype=dtype,
                with_order=with_order)
            same = [bool(torch.equal(r, g)) for r, g in zip(plain(),
                                                           kernel())]
            print(f"kernel squelch_gate {str(dtype)[6:]} [4000, {C_small}] "
                  f"order {with_order}: equal to plain up to the sign of "
                  f"zero {same}", flush=True)
            if not all(same):
                raise AssertionError("squelch_gate disagrees with its plain "
                                     "version")
    times["squelch_gate"] = times["squelch_gate_float32"][:2]
    return times


def _close_to_cpu(label: str, got, ref, tol: float) -> None:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    snr = 20 * np.log10(np.linalg.norm(ref)
                        / max(np.linalg.norm(got - ref), 1e-300))
    print(f"{label}: card vs CPU snr {snr:.2f} dB (tol {tol} dB), "
          f"shape {got.shape}", flush=True)
    if got.shape != ref.shape or not snr >= tol:
        raise AssertionError(f"{label} disagrees with the CPU")


def phase_chain(device, seed: int = 6) -> None:
    """The chain's own entry points on the card, each against the same call
    on the CPU: `chain.process` on 2560 receivers with the tail kernel
    (one launch), `chain.run_offline` for one 12 kHz AM receiver and one
    20.25 kHz receiver (rational resampling), and a MID chan-major run
    through the fused channelizer and the tail kernel."""
    from supersdr_tpu_torch.runtime import chain
    from supersdr_tpu_torch.runtime import wideband as wb
    rng = np.random.default_rng(seed)
    cpu = torch.device("cpu")
    tol = TOL_SNR_DB["cpu"]

    def am_iq(shape, fs):
        t = np.arange(shape[-1]) / fs
        z = 0.3 * (1 + 0.6 * np.sin(2 * np.pi * 700.0 * t)) * np.exp(
            2j * np.pi * rng.uniform(-500, 500, size=shape[:-1] + (1,)) * t)
        return (z + 0.01 * (rng.normal(size=shape) + 1j * rng.normal(
            size=shape))).astype(np.complex64)

    ccfg = chain.ChainConfig(tail_impl="pallas")
    offs = np.linspace(-400.0, 400.0, 2560)
    iq = am_iq((2560, ccfg.chunk), ccfg.iq_rate)
    outs = {}
    for key, dev in (("card", device), ("cpu", cpu)):
        p = chain.make_params(ccfg, freq_offset_hz=offs, device=dev)
        _reset_counts()
        _, out = chain.process(ccfg, p, chain.init_state(ccfg, (2560,),
                                                         device=dev), iq)
        _sync(dev)
        outs[key] = (out.audio.cpu().numpy(), _counts())
    print(f"chain.process 2560 receivers: launches {outs['card'][1]}",
          flush=True)
    if outs["card"][1]["chain_tail_am_c"] != 1:
        raise AssertionError("chain.process did not run the tail kernel")
    _close_to_cpu("chain.process 2560 receivers", outs["card"][0],
                  outs["cpu"][0], tol)
    for rate, chunk in ((12_000, 2048), (20_250, 2025)):
        cfg = chain.ChainConfig(iq_rate=rate, chunk=chunk, os_block=chunk)
        x = am_iq((3 * chunk + 777,), rate)
        got = chain.run_offline(cfg, chain.make_params(cfg, device=device),
                                x)[1]
        ref = chain.run_offline(cfg, chain.make_params(cfg, device=cpu),
                                x)[1]
        _close_to_cpu(f"chain.run_offline {rate} Hz", got, ref, tol)
    cfg = wb.WidebandConfig(**MID, chan_impl="mxu2fused",
                            passband_impl="matmul", tail_impl="pallas")
    x = (rng.normal(size=cfg.chunk_in) + 1j * rng.normal(size=cfg.chunk_in)
         ).astype(np.complex64) * 0.05
    res = {}
    for key, dev in (("card", device), ("cpu", cpu)):
        _reset_counts()
        _, out = wb.process(cfg, wb.make_params(cfg, device=dev),
                            wb.init_state(cfg, device=dev), x)
        _sync(dev)
        res[key] = (out.audio.cpu().numpy(), _counts())
    print(f"chan-major mxu2fused MID: launches {res['card'][1]}", flush=True)
    if res["card"][1]["channelize_fused"] != 1 \
            or res["card"][1]["chain_tail_am_c"] != 1:
        raise AssertionError("chan-major mxu2fused missed a kernel")
    _close_to_cpu("chan-major mxu2fused MID", res["card"][0],
                  res["cpu"][0], tol)


# the reference's chan-major channelizer variants (`chan_impl`,
# `chan_fold_dtype`, `chan_fft_form`, `mxu_chan_fft`), each behind the
# non-FIR tail kernel
VARIANT_ROUTES = {
    "stub": dict(chan_impl="stub"),
    "nofft": dict(chan_impl="nofft"),
    "mxu2": dict(chan_impl="mxu2"),
    "mxu2_f16": dict(chan_impl="mxu2", chan_fold_dtype="f16"),
    "mxu2conv": dict(chan_impl="mxu2conv"),
    "mxu2pallas": dict(chan_impl="mxu2pallas"),
    "dit": dict(chan_impl="mxu2", chan_fft_form="dit"),
    "legacy_mxu_fft": dict(chan_impl="legacy", mxu_chan_fft=True),
}
# the reference's one-row matrix-product overlap-save passband
FFTMXU = dict(mode="AM", iq_rate=12_000, audio_rate=48_000, chunk=2048,
              os_block=2048, n_taps=257, passband_impl="fftmxu",
              tail_impl="pallas")
FIXTURE = "tests/fixtures/kiwi_am_offair_12k.wav"
# the reference's off-air acceptance bound against its scipy oracle
OFFAIR_ORACLE_DB = 40.0


def _offair_oracle_db(audio: np.ndarray, z: np.ndarray, fs: int = 12_000
                      ) -> float:
    """The reference's off-air acceptance check (its
    tests/test_offair_fixture.py): a scipy oracle of the documented AM
    semantics (firwin lowpass, envelope, the one-pole DC blocker at
    0.999), lifted to 48 kHz by the port's interpolator, against the audio
    at the best lag within ±64 samples, past the first second."""
    import scipy.signal as sps
    from supersdr_tpu_torch.ops import resample
    y = sps.lfilter(sps.firwin(513, 5900, fs=fs), 1.0, z)
    ref12 = sps.lfilter([1.0, -1.0], [1.0, -0.999], np.abs(y))
    plan, P = resample.design_interp(fs, 4 * fs)
    ref = resample.interpolate(
        plan, torch.from_numpy(np.asarray(P, np.float32)),
        resample.init_carry(plan, device="cpu"),
        torch.from_numpy(np.asarray(ref12, np.float32)))[1].numpy()
    n = min(len(audio), len(ref))
    a, b = np.asarray(audio[:n], np.float64), ref[:n].astype(np.float64)
    best = -np.inf
    for lag in range(-64, 65):
        aa = a[max(lag, 0): n + min(lag, 0)][48000:-4000]
        bb = b[max(-lag, 0): n - max(lag, 0)][48000:-4000]
        aa, bb = aa - aa.mean(), bb - bb.mean()
        g = np.dot(aa, bb) / max(np.dot(bb, bb), 1e-30)
        err = aa - g * bb
        best = max(best, 10 * np.log10(np.dot(g * bb, g * bb)
                                       / max(np.dot(err, err), 1e-30)))
    return best


def phase_variants(device, tmp: str, iters: int = 5, seed: int = 41
                   ) -> dict:
    """The reference's channelizer and passband variants on the card
    (`variants`). Each chan-major route of VARIANT_ROUTES at MID with the
    tail kernel, two chained chunks, against the same config on the CPU
    (TOL_SNR_DB["cpu"]; "stub" also bit for bit at the channelizer): one
    `chain_tail_am_c` launch a chunk, and `mxu2pallas` one fold launch a
    chunk. `fftmxu` through `chain.process` on 128 receivers × 2048 (the
    tail kernel) and through `sharded_chain` on 8 receivers × 8 time
    shards (the halo kernel: AM exchanges 3 halos a call), each against
    the CPU. The off-air fixture through `cli demod --mode AM --agc-off`
    on the card against the reference's scipy oracle (≥
    OFFAIR_ORACLE_DB). Then each route's ms a chunk at HEADLINE beside
    CHANMAJOR's, with the card's name and power limit."""
    from supersdr_tpu_torch.io import wav
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.parallel import mesh, sharded_chain
    from supersdr_tpu_torch.runtime import chain
    from supersdr_tpu_torch.runtime import wideband as wb
    cpu = torch.device("cpu")
    tol = TOL_SNR_DB["cpu"]
    rng = np.random.default_rng(seed)
    n = MID["chunk_in"]
    x = [((rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.05
          ).astype(np.complex64) for _ in range(2)]
    none = {k: 0 for k in _wrappers()}
    total = dict(none)

    def check(label, launches, want):
        print(f"variants {label}: launches {launches}", flush=True)
        if launches != {**none, **want}:
            raise AssertionError(f"variants {label}: launches {launches}, "
                                 f"want {want}")
        for k, v in launches.items():
            total[k] += v
    for name, kw in VARIANT_ROUTES.items():
        cfg = wb.WidebandConfig(**{**MID, "tail_impl": "pallas", **kw})
        res = {}
        for key, dev in (("card", device), ("cpu", cpu)):
            p = wb.make_params(cfg, device=dev)
            _reset_counts()
            _, outs = wb.process_n(cfg, p, wb.init_state(cfg, device=dev),
                                   x)
            _sync(dev)
            res[key] = (torch.cat(outs, dim=-1).cpu().numpy(), _counts())
        want = {"chain_tail_am_c": len(x)}
        if name == "mxu2pallas":
            want["pfb_fold"] = len(x)
        check(f"{name} MID", res["card"][1], want)
        _close_to_cpu(f"variants {name} MID", res["card"][0], res["cpu"][0],
                      tol)
    cfg = wb.WidebandConfig(**{**MID, **VARIANT_ROUTES["stub"]})
    plan = wb.pfb_plan(cfg)
    carry = cx.as_cx(x[1][:plan.history], device=cpu)
    got, ref = (wb.channelize_dispatch(
        cfg, wb.make_params(cfg, device=dev),
        cx.CX(*(t.to(dev) for t in carry)), cx.as_cx(x[0], device=dev))
        for dev in (device, cpu))
    exact = torch.equal(got[1].cpu(), ref[1]) \
        and torch.equal(got[0].re.cpu(), ref[0].re)
    print(f"variants stub channelizer: card and CPU bit for bit {exact}",
          flush=True)
    if not exact:
        raise AssertionError("variants stub: the channelizer differs")
    # fftmxu: chain.process on 128 receivers, two chained chunks
    ccfg = chain.ChainConfig(**FFTMXU)
    offs = np.linspace(-300.0, 300.0, 128)
    iq = _sharded_iq(128, 2 * ccfg.chunk, ccfg.iq_rate, seed)
    res = {}
    for key, dev in (("card", device), ("cpu", cpu)):
        p = chain.make_params(ccfg, freq_offset_hz=offs, device=dev)
        st = chain.init_state(ccfg, (128,), device=dev)
        _reset_counts()
        outs = []
        for k in range(2):
            st, out = chain.process(ccfg, p, st,
                                    iq[:, k * ccfg.chunk:(k + 1) * ccfg.chunk])
            outs.append(out.audio)
        _sync(dev)
        res[key] = (torch.cat(outs, dim=-1).cpu().numpy(), _counts())
    check("fftmxu chain.process 128 receivers", res["card"][1],
          {"chain_tail_am_c": 2})
    _close_to_cpu("variants fftmxu chain.process 128 receivers",
                  res["card"][0], res["cpu"][0], tol)
    # fftmxu: the sharded chain, the halo kernel
    scfg = chain.ChainConfig(**dict(FFTMXU, chunk=16384, os_block=16384,
                                    tail_impl="xla"))
    offs = np.linspace(-300.0, 300.0, SHARDED_RX)
    ncall = scfg.chunk * SHARDED_D
    iq = _sharded_iq(SHARDED_RX, 2 * ncall, scfg.iq_rate, seed + 1)
    res = {}
    for key, dev in (("card", device), ("cpu", cpu)):
        proc = sharded_chain.build(scfg, mesh.make_mesh(1, SHARDED_D,
                                                        device=dev))
        p = sharded_chain.make_params(scfg, SHARDED_RX, offs, device=dev)
        st = sharded_chain.init_state(scfg, SHARDED_RX, device=dev)
        _reset_counts()
        outs = []
        for k in range(2):
            st, out = proc(p, st, iq[:, k * ncall:(k + 1) * ncall])
            outs.append(out.audio)
        _sync(dev)
        res[key] = (torch.cat(outs, dim=-1).cpu().numpy(), _counts())
    check(f"fftmxu sharded_chain {SHARDED_RX}x(1x{SHARDED_D})",
          res["card"][1], {"halo": 3 * 2})
    _close_to_cpu(f"variants fftmxu sharded_chain {SHARDED_RX}x(1x"
                  f"{SHARDED_D})", res["card"][0], res["cpu"][0], tol)
    # the off-air fixture through the user's command, on the card
    out = os.path.join(tmp, "offair_am.wav")
    _cli(["demod", FIXTURE, "-o", out, "--mode", "AM", "--agc-off"])
    audio, rate = wav.read_audio_wav(out)
    snr = _offair_oracle_db(np.asarray(audio).reshape(-1),
                            wav.read_kiwi_iq_wav(FIXTURE)[1])
    print(f"variants cli demod AM off-air fixture: {snr:.2f} dB against "
          f"the scipy oracle (tol {OFFAIR_ORACLE_DB} dB), {rate} Hz",
          flush=True)
    if not snr >= OFFAIR_ORACLE_DB:
        raise AssertionError("the off-air fixture misses the oracle")
    # each route's ms a chunk at HEADLINE beside CHANMAJOR's
    gen = torch.Generator(device=device).manual_seed(seed)
    chunks = [cx.CX(*(torch.randn(HEADLINE["chunk_in"], generator=gen,
                                  device=device) * 0.05 for _ in range(2)))
              for _ in range(2)]
    smi = _nvidia_smi()
    times = {}
    for name, kw in (("chanmajor", CHANMAJOR), *VARIANT_ROUTES.items()):
        cfg = wb.WidebandConfig(**{**HEADLINE, "tail_impl": "pallas", **kw})
        p = wb.make_params(cfg, device=device)
        st = [wb.init_state(cfg, device=device)]

        def step():
            st[0], outs = wb.process_n(cfg, p, st[0], chunks)
            return outs[-1].abs().mean()
        ms = cuda_ms(step, iters) / len(chunks)
        times[f"variant_{name}"] = ms
        print(f"time variants {name} HEADLINE: {ms:.3f} ms/chunk, "
              f"{cfg.chunk_in / (ms * 1e-3) / 1e6:.1f} Msamples/s input "
              f"({smi})", flush=True)
        del p, st
    torch.cuda.empty_cache()
    return {"launches": total, "times": times}


TAIL_ENTRIES = {"chain_tail": 0, "chain_tail_am": 1, "chain_tail_am_c": 2}


def _tail_launch_info(name: str, label: str, C: int, ccfg,
                      variant: int = 0) -> None:
    """What a tail entry (`TAIL_ENTRIES`; the FIR entry's `variant` =
    demod | complex taps << 2 | bf16 operands << 3 | bf16 input rows << 4)
    launches at these
    shapes, from the runtime and the occupancy calculator: registers and
    stack bytes a thread, shared bytes a block, grid, blocks an SM, cluster
    dims and the clusters resident at once, and whether the grid is one
    wave."""
    import ctypes
    from supersdr_tpu_torch import _build
    from supersdr_tpu_torch.ops.cuda import chain_tail as ct
    from supersdr_tpu_torch.runtime import chain
    lib = _build.load()
    tile = chain._tail_tile(ccfg.chunk, ccfg.n_taps)
    hang = ct.hang_tiles_for(chain._tail_hang_window(ccfg), tile)
    out = (ctypes.c_long * 8)()
    _build.check(lib.chain_tail_launch(
        TAIL_ENTRIES[name], C, ccfg.n_taps, variant, ccfg.interp_plan.per,
        ccfg.upsample, tile, hang, ctypes.cast(out, ctypes.c_void_p)),
        "chain_tail_launch")
    info = dict(zip(("smem", "blocks", "threads", "per_sm", "cluster",
                     "clusters", "regs", "stack"), out))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one_wave = (info["clusters"] * info["cluster"] if info["cluster"] > 1
                else info["per_sm"] * sms) >= info["blocks"]
    print(f"launch {name} {label}: {info['regs']} registers, "
          f"{info['stack']} bytes stack; {info['smem']} bytes shared a "
          f"block, {info['blocks']} blocks of {info['threads']} threads, "
          f"{info['per_sm']} blocks an SM; cluster ({info['cluster']}, 1, "
          f"1), {info['clusters']} clusters resident at once; one wave: "
          f"{one_wave} ({C} channels, seg {tile}, {hang} hang slots)",
          flush=True)


def _fir_launch_info(cfg, label: str, C: int) -> None:
    """`_tail_launch_info` of every FIR-tail instance (demodulator ×
    complex taps × operand type) at cfg's chain, on the planar path's rows
    (bf16 for bf16 operands, else float32), and of the bf16 instances on
    the float32 rows of the 2-D source."""
    for demod in range(3):
        for cplx in (0, 1):
            for bf16, rows in ((0, 0), (1, 1), (1, 0)):
                _tail_launch_info("chain_tail", f"{label} demod {demod} "
                                  f"complex {cplx} bf16 {bf16} rows "
                                  f"{'bf16' if rows else 'f32'}", C,
                                  cfg.chain_cfg, demod | cplx << 2
                                  | bf16 << 3 | rows << 4)


def _chan_launch_info(cfg) -> None:
    """What every channelizer instance launches at cfg's shape (the serial
    (n1, n2) and the mesh's on MESH_D shards), from `launch_info`:
    registers and local bytes a thread, shared bytes, grid, blocks an SM,
    frames a block; and the bytes of its tables and what a block reads of
    them out of L2."""
    from supersdr_tpu_torch.ops.cuda import channelize_fused as cf
    from supersdr_tpu_torch.parallel import sharded_wideband as sw
    from supersdr_tpu_torch.runtime import wideband as wb
    M, K, nf = cfg.n_chan, cfg.taps_per, cfg.chunk_per_chan
    n1, n2 = wb._factors_for(cfg)
    m1, m2, m1_pad = sw.plan_mesh(cfg, MESH_D).factors
    cases = []
    for fast in (True, False):
        outs = (("bf16", "raw3"),) if fast else ()
        outs += (("f32", "raw3"), ("f32", "time"))
        for i16 in (False, True):
            for out, layout in outs:
                cases.append((fast, i16, out, layout, n1, n2, 1, n1))
            cases.append((fast, i16, "bf16" if fast else "f32", "raw3", m1,
                          m2, MESH_D, m1_pad))
    for fast, i16, out, layout, f1, f2, D, n1_out in cases:
        info = cf.launch_info(
            nf=nf // D, M=M, K=K, n1=f1, n2=f2, bf16_b=fast, in_i16=i16,
            out_dtype=torch.bfloat16 if out == "bf16" else torch.float32,
            out_layout=layout, n_shards=D, n1_out=n1_out)
        print(f"launch channelize_fused {'fast' if fast else 'quality'} "
              f"{'i16' if i16 else 'f32'} in, {out} {layout} ({f1}, {f2}) "
              f"D={D} n1_out={n1_out}: {info['regs']} registers, "
              f"{info['local']} bytes local; {info['smem']} bytes shared a "
              f"block, {info['blocks']} blocks of {info['threads']} threads, "
              f"{info['per_sm']} blocks an SM, {info['frames']} frames a "
              f"block; tables {info['table_bytes']} bytes, "
              f"{info['l2_table_bytes']} bytes a block out of L2", flush=True)


def phase_am_batch(device, err: dict, iters: int = 20,
                   seed: int = 16) -> dict:
    """The non-FIR tail as `chain.process` runs it on a batch of receivers
    (the chain's default chunk of 2048, 128 and 2560 receivers): the
    kernel against its plain version, its time, the grid, and
    `chain.process` ms a call (one tail launch each)."""
    from supersdr_tpu_torch.runtime import chain
    gen = torch.Generator(device=device).manual_seed(seed)
    ccfg = chain.ChainConfig(tail_impl="pallas")
    times = {}
    for n_rx in (128, 2560):
        y = torch.randn(n_rx, ccfg.chunk, generator=gen, device=device,
                        dtype=torch.complex64) * 0.05
        kernel, plain = _am_case(n_rx, ccfg.chunk, gen, device=device, y=y,
                                 n_taps=ccfg.n_taps)
        _compare("chain_tail_am_c", f"batch {n_rx} x {ccfg.chunk}", kernel,
                 plain, TOL_SNR_DB["tail"], device, err)
        k_ms = cuda_ms_queued(kernel, iters, device)
        p = chain.make_params(ccfg, device=device)
        st = [chain.init_state(ccfg, (n_rx,), device=device)]
        iq = torch.randn(n_rx, ccfg.chunk, generator=gen, device=device,
                         dtype=torch.complex64) * 0.1

        def step():
            st[0], out = chain.process(ccfg, p, st[0], iq)
            return out.audio
        _reset_counts()
        step()
        _sync(device)
        if _counts()["chain_tail_am_c"] != 1:
            raise AssertionError("chain.process did not run the tail kernel")
        c_ms = cuda_ms(step, 5)
        times[f"chain_tail_am_c_batch{n_rx}"] = (k_ms, cuda_ms(plain, 2))
        print(f"time chain_tail_am_c batch {n_rx} x {ccfg.chunk}: kernel "
              f"{k_ms:.4f} ms; chain.process {c_ms:.3f} ms a call",
              flush=True)
        _tail_launch_info("chain_tail_am_c", f"batch {n_rx}", n_rx, ccfg)
        del y, iq, st
    return times


def phase_halo(device, err: dict, seed: int = 8) -> None:
    """The halo kernel against its plain version, bit for bit (a copy
    agrees exactly or is wrong): float32, int16 pairs and complex64; 1, 16
    and 256 samples; 1, 2 and 8 shards; 1, 8 and 2560 rows; a strided
    source; a −inf fill; two hops; with and without a head for shard 0;
    and a several-hop context written in place."""
    from supersdr_tpu_torch.ops.cuda import halo
    from supersdr_tpu_torch.parallel import collectives
    gen = torch.Generator(device=device).manual_seed(seed)
    n_local, n_cases = 512, 0

    def rand(shape, kind):
        if kind == "i16":
            return (torch.randn(shape, generator=gen, device=device) * 3000
                    ).to(torch.int16)
        if kind == "c64":
            return torch.randn(shape, generator=gen, device=device,
                               dtype=torch.complex64)
        return torch.randn(shape, generator=gen, device=device)

    def check(label, x, n, fill=0.0, **kw):
        nonlocal n_cases
        got = halo.left_halo(x, n, fill, **kw)
        want = halo.left_halo_plain(x, n, fill, **kw)
        _sync(device)
        pairs = [(got, want)] if isinstance(got, torch.Tensor) \
            else list(zip(got, want))
        for g, w in pairs:
            if g.shape != w.shape or not torch.equal(
                    torch.view_as_real(g) if g.is_complex() else g,
                    torch.view_as_real(w) if w.is_complex() else w):
                raise AssertionError(f"halo {label} differs from its plain "
                                     f"version")
        n_cases += 1

    for kind in ("f32", "i16", "c64"):
        for n in (1, 16, 256):
            for D in (1, 2, 8):
                for R in (1, 8, 2560):
                    x = rand((R, D, n_local), kind)
                    if kind == "i16":
                        x = (x, rand((R, D, n_local), kind))
                    check(f"{kind} n={n} D={D} R={R}", x, n)
                    head = rand((R, n), kind)
                    if kind == "i16":
                        head = (head, rand((R, n), kind))
                    check(f"{kind} n={n} D={D} R={R} head0", x, n,
                          head0=head)
    x = rand((8, 8, 2 * n_local), "f32")[:, :, ::2]      # element stride 2
    check("strided source", x, 16)
    check("strided batch", rand((16, 8, n_local), "f32")[::2], 16)
    check("fill -inf", rand((8, 8, n_local), "f32"), 16, -torch.inf)
    check("two hops", rand((8, 8, n_local), "c64"), 256, hop=2)
    check("nine hops", rand((8, 8, n_local), "f32"), 4, 1.5, hop=9)
    xs = rand((8, 8, 64), "f32")
    ctx = collectives.left_context(xs, 150, fill=-torch.inf)
    ref = collectives.left_context(xs, 150, fill=-torch.inf,
                                   impl="ppermute")
    _sync(device)
    if not torch.equal(ctx, ref):
        raise AssertionError("halo left_context differs from its plain "
                             "version")
    err["halo"] = 0.0
    print(f"kernel halo: {n_cases + 1} cases bit-exact against the plain "
          f"version", flush=True)


def _sharded_iq(n_chan: int, n: int, fs: float, seed: int) -> np.ndarray:
    """AM carriers at a few hundred Hz over noise, [n_chan, n] complex64."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f_c = rng.uniform(-500.0, 500.0, size=(n_chan, 1))
    z = 0.3 * (1 + 0.6 * np.sin(2 * np.pi * 700.0 * t)) * np.exp(
        2j * np.pi * f_c * t)
    return (z + 0.01 * (rng.normal(size=z.shape) + 1j * rng.normal(
        size=z.shape))).astype(np.complex64)


def phase_sharded(device, seed: int = 9, iters: int = 5) -> dict:
    """The sharded receiver chain on one card. Two configs, two chained
    calls each: SHARDED (8 receivers × 8 time shards of 131072 samples, AM,
    matmul passband) and a 2 × 4 chan × time grid (USB, fft passband, AGC
    on). halo_impl="rdma" must launch the halo kernel as often as the mode
    exchanges halos (AM: filter history, DC block, resampler: 3 a call;
    USB: 2) and "ppermute" never; both give identical audio; the sharded
    audio must equal the serial chain on the whole capture on the card and
    the same sharded calls on the CPU. Prints ms a call and input
    Msamples/s for sharded and serial."""
    from supersdr_tpu_torch.parallel import mesh, sharded_chain
    from supersdr_tpu_torch.runtime import chain
    cpu = torch.device("cpu")
    tol = TOL_SNR_DB["cpu"]
    agc_on = dict(on=True, thresh_db=-80, decay_ms=1000)
    cases = (
        ("SHARDED 8x(1x8) AM matmul", SHARDED, (1, SHARDED_D), 3),
        ("grid 8x(2x4) USB fft", dict(SHARDED, mode="USB",
                                      passband_impl="fft"), (2, 4), 2))
    total = 0
    for label, kw, grid, halos in cases:
        cfg = chain.ChainConfig(**kw)
        n = cfg.chunk * grid[1]
        offs = np.linspace(-300.0, 300.0, SHARDED_RX)
        iq = _sharded_iq(SHARDED_RX, 2 * n, cfg.iq_rate, seed)
        calls = [iq[:, :n], iq[:, n:]]

        def run(dev, impl):
            m = mesh.make_mesh(*grid, device=dev)
            proc = sharded_chain.build(cfg, m, halo_impl=impl)
            p = sharded_chain.make_params(cfg, SHARDED_RX, offs,
                                          agc_kwargs=agc_on, device=dev)
            st = sharded_chain.init_state(cfg, SHARDED_RX, device=dev)
            outs = []
            for c in calls:
                st, out = proc(p, st, c)
                outs.append(out.audio)
            _sync(dev)
            return proc, p, st, torch.cat(outs, dim=-1)

        _reset_counts()
        proc, p, st, audio = run(device, "rdma")
        launches = _counts()
        _reset_counts()
        _, _, _, audio_pp = run(device, "ppermute")
        launches_pp = _counts()
        same = torch.equal(audio, audio_pp)
        finite = bool(torch.isfinite(audio).all())
        print(f"sharded {label}: halo launches rdma {launches['halo']} "
              f"(want {halos * len(calls)}), ppermute {launches_pp['halo']}; "
              f"identical audio {same}; audio {tuple(audio.shape)} "
              f"finite={finite}", flush=True)
        others = sum(v for k, v in launches.items() if k != "halo")
        if launches["halo"] != halos * len(calls) or launches_pp["halo"] \
                or others or not same or not finite:
            raise AssertionError(f"sharded {label} failed")
        total += launches["halo"]
        # the serial chain on each whole call, on the card
        scfg = chain.ChainConfig(**dict(kw, chunk=n, os_block=cfg.chunk))
        sp = chain.make_params(scfg, freq_offset_hz=offs, agc_kwargs=agc_on,
                               device=device)
        sst = chain.init_state(scfg, (SHARDED_RX,), device=device)
        souts = []
        for c in calls:
            sst, out = chain.process(scfg, sp, sst, c)
            souts.append(out.audio)
        _close_to_cpu(f"sharded {label} vs serial chain on the card",
                      audio.cpu().numpy(),
                      torch.cat(souts, dim=-1).cpu().numpy(), tol)
        _, _, _, audio_cpu = run(cpu, "rdma")
        _close_to_cpu(f"sharded {label}", audio.cpu().numpy(),
                      audio_cpu.numpy(), tol)
        x = torch.as_tensor(calls[0], device=device)
        hold = [st, sst]

        def step_sharded():
            hold[0], out = proc(p, hold[0], x)
            return out.audio.abs().mean()

        def step_serial():
            hold[1], out = chain.process(scfg, sp, hold[1], x)
            return out.audio.abs().mean()
        for name, fn in (("sharded", step_sharded), ("serial", step_serial)):
            ms = cuda_ms(fn, iters)
            print(f"time {label} {name}: {ms:.3f} ms/call, "
                  f"{SHARDED_RX * n / (ms * 1e-3) / 1e6:.1f} Msamples/s "
                  f"input", flush=True)
            if kw is SHARDED:
                device_share(f"{label} {name}", fn)
    return {"launches": {**{k: 0 for k in _wrappers()}, "halo": total}}


def phase_halo_timing(device, iters: int = 200, seed: int = 10) -> dict:
    """The halo kernel at the sharded chain's passband exchange (8 rows ×
    8 shards × 131072 complex samples, 256 of history, the stream's carry
    as shard 0's head) beside an empty launch, its plain version and the
    slice copy PyTorch would make (the library yardstick, which the port
    never calls). Two clocks: the card's time a launch with the launches
    queued, and the time of one call as the host makes it."""
    from supersdr_tpu_torch.ops.cuda import halo
    gen = torch.Generator(device=device).manual_seed(seed)
    n = SHARDED["n_taps"] - 1
    x = torch.randn(SHARDED_RX, SHARDED_D, SHARDED["chunk"], generator=gen,
                    device=device, dtype=torch.complex64)
    head = tuple(torch.randn(SHARDED_RX, n, generator=gen, device=device)
                 for _ in range(2))
    head_c = torch.complex(*head)
    out = torch.empty(SHARDED_RX, SHARDED_D, n, dtype=torch.complex64,
                      device=device)

    def library():
        out[:, 1:] = x[:, :-1, -n:]
        out[:, 0] = head_c
        return out
    got = halo.left_halo(x, n, head0=head)
    _sync(device)
    if not torch.equal(torch.view_as_real(got),
                       torch.view_as_real(library())):
        raise AssertionError("halo disagrees with the slice copy")
    calls = {"kernel": lambda: halo.left_halo(x, n, head0=head, out=out),
             "plain": lambda: halo.left_halo_plain(x, n, head0=head,
                                                   out=out),
             "library": library,
             "empty": lambda: halo.empty_launch(device)}
    # on the card (launches queued behind other work) and as a caller sees
    # one call (the host's Python and ctypes work included)
    dev_ms = {k: cuda_ms_queued(f, iters, device) for k, f in calls.items()}
    call_ms = {k: cuda_ms(f, iters) for k, f in calls.items()}
    moved = 2 * out.numel() * out.element_size()     # read once, write once
    b_ms, by = bound_ms(moved, {})
    print(f"time halo [{SHARDED_RX}, {SHARDED_D}, {n}] complex64 on the "
          f"card: kernel {dev_ms['kernel'] * 1e3:.2f} us, plain "
          f"{dev_ms['plain'] * 1e3:.2f} us, slice copy "
          f"{dev_ms['library'] * 1e3:.2f} us, empty launch "
          f"{dev_ms['empty'] * 1e3:.2f} us, bytes bound {b_ms * 1e3:.3f} us "
          f"({moved} bytes)", flush=True)
    print(f"time halo a call from the host: kernel "
          f"{call_ms['kernel'] * 1e3:.2f} us, plain "
          f"{call_ms['plain'] * 1e3:.2f} us, slice copy "
          f"{call_ms['library'] * 1e3:.2f} us, empty launch "
          f"{call_ms['empty'] * 1e3:.2f} us", flush=True)
    return {"halo": (dev_ms["kernel"], dev_ms["plain"]),
            "halo_library": dev_ms["library"],
            "halo_empty": dev_ms["empty"], "halo_call": call_ms["kernel"],
            "halo_bound": (b_ms, by)}


def phase_tmajor(device, err: dict, planar_ms: dict, iters: int = 5,
                 seed: int = 11) -> dict:
    """The time-major tier off the planar coupling at TMAJOR (2560 channels
    × 16200 frames), both profiles: the reference's predicates put it
    there; one channelizer and one FIR-tail launch a chunk; audio
    [frames·4, 2560] finite, against the chan-major tier's audio on the
    card at the same chunk; ms a chunk beside the planar path's; the
    channelizer's time store and the tail's 2-D source against their plain
    versions at this shape. Then a 33-tap passband (no in-tail FIR block):
    the standalone Toeplitz passband and the non-FIR tail."""
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.runtime import wideband as wb
    gen = torch.Generator(device=device).manual_seed(seed)
    n = TMAJOR["chunk_in"]
    chunks = [cx.CX(*(torch.randn(n, generator=gen, device=device) * 0.05
                      for _ in range(2))) for _ in range(2)]
    total = {k: 0 for k in _wrappers()}
    times = {}
    for prof in ("fast", "quality"):
        cfg = wb.WidebandConfig(**TMAJOR, **wb.PROFILES[prof])
        if wb._planar_active(cfg) or not wb._tmajor_fused_ok(cfg):
            raise AssertionError(f"TMAJOR {prof} is on another tier")
        params = wb.make_params(cfg, device=device)
        _reset_counts()
        st, outs = wb.process_n(cfg, params, wb.init_state(cfg, device=device),
                                chunks)
        _sync(device)
        launches = _counts()
        want = {**{k: 0 for k in launches},
                "channelize_fused": len(chunks), "chain_tail": len(chunks)}
        shape_ok = all(tuple(a.shape) == (cfg.chunk_per_chan * 4, cfg.n_chan)
                       for a in outs)
        finite = all(bool(torch.isfinite(a).all()) for a in outs)
        print(f"main path tmajor {prof}: launches {launches} for "
              f"{len(chunks)} chunks; audio {tuple(outs[0].shape)} "
              f"finite={finite}", flush=True)
        if launches != want or not shape_ok or not finite:
            raise AssertionError(f"tmajor {prof} failed")
        for k, v in launches.items():
            total[k] += v
        ccfg = wb.WidebandConfig(**TMAJOR, **dict(wb.PROFILES[prof],
                                                  time_major=False))
        _, outs_c = wb.process_n(ccfg, params,
                                 wb.init_state(ccfg, device=device), chunks)
        for k, (a, c) in enumerate(zip(outs, outs_c)):
            snr = _snr_db(c.T, a)
            print(f"tmajor {prof} chunk {k} vs chan-major tier: snr "
                  f"{snr:.2f} dB (tol {TOL_TIER_DB[prof]} dB)", flush=True)
            if not snr >= TOL_TIER_DB[prof]:
                raise AssertionError(f"tmajor {prof} disagrees with the "
                                     f"chan-major tier")
        del outs_c
        # int16 ingest goes to the kernel as it is: the same audio as the
        # dequantized float32 chunk
        q = tuple((p * 32768.0).round().clamp(-32768, 32767).to(torch.int16)
                  for p in chunks[0])
        deq = cx.CX(*(p.float() * (1.0 / 32768.0) for p in q))
        _, o_q = wb.process(cfg, params, wb.init_state(cfg, device=device), q)
        _, o_f = wb.process(cfg, params, wb.init_state(cfg, device=device),
                            deq)
        snr = _snr_db(o_f.audio, o_q.audio)
        print(f"tmajor {prof} i16 vs dequantized f32: snr {snr:.2f} dB "
              f"(tol {TOL_SNR_DB['cpu']} dB)", flush=True)
        if not snr >= TOL_SNR_DB["cpu"]:
            raise AssertionError(f"tmajor {prof} i16 ingest disagrees")
        del o_q, o_f, q, deq
        hold = [st]

        def step():
            hold[0], o = wb.process_n(cfg, params, hold[0], chunks)
            return o[-1].abs().mean()
        ms = cuda_ms(step, iters) / len(chunks)
        print(f"time main path tmajor {prof} f32: {ms:.3f} ms/chunk, "
              f"{cfg.chunk_in / (ms * 1e-3) / 1e6:.1f} Msamples/s input "
              f"(planar at 16128 frames: {planar_ms[prof]:.3f} ms/chunk)",
              flush=True)
        times[f"main_tmajor_{prof}"] = ms
        label = f"{prof} nf={cfg.chunk_per_chan}"
        kernel, plain = _chan_case(cfg, params, gen, i16=False,
                                   device=device, layout="time")
        _compare("channelize_fused", f"{label} time", kernel, plain,
                 TOL_SNR_DB["chan_" + prof], device, err)
        times[f"channelize_fused_time_{prof}"] = (cuda_ms(kernel, iters),
                                                  cuda_ms(plain, 2))
        k16, p16 = _chan_case(cfg, params, gen, i16=True, device=device,
                              layout="time")
        _compare("channelize_fused", f"{label} i16 time", k16, p16,
                 TOL_SNR_DB["chan_" + prof], device, err)
        print(f"time channelize_fused_time {prof} i16: kernel "
              f"{cuda_ms(k16, iters):.3f} ms", flush=True)
        del k16, p16
        kernel, plain = _tail_case(cfg, params, gen, device=device,
                                   raw=kernel(), time2d=True)
        _compare("chain_tail", f"{label} AM 2-D source", kernel, plain,
                 TOL_SNR_DB["tail"], device, err)
        times[f"chain_tail_2d_{prof}"] = (cuda_ms(kernel, iters),
                                          cuda_ms(plain, 2))
        for name in ("channelize_fused_time", "chain_tail_2d"):
            k_ms, p_ms = times[f"{name}_{prof}"]
            print(f"time {name} {prof}: kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms", flush=True)
    # no in-tail FIR block: 32 taps of history are under the 64 a block
    # needs, and the standalone block (128) divides 16128 frames
    cfg = wb.WidebandConfig(**dict(HEADLINE, n_taps=33),
                            **wb.PROFILES["quality"])
    params = wb.make_params(cfg, device=device)
    if wb._planar_active(cfg) or not wb._tmajor_fused_ok(cfg) \
            or params.chain.W_tailpass is not None:
        raise AssertionError("the 33-tap config is on another tier")
    short = [cx.CX(c.re[:cfg.chunk_in], c.im[:cfg.chunk_in]) for c in chunks]
    _reset_counts()
    st, out = wb.process(cfg, params, wb.init_state(cfg, device=device),
                         short[0])
    st, out = wb.process(cfg, params, st, short[1])
    _sync(device)
    launches = _counts()
    want = {**{k: 0 for k in launches}, "channelize_fused": 2,
            "chain_tail_am": 2}
    # the non-FIR tail as this branch launched it (time-major planes, the
    # power row, time-major audio) against its plain version, on the
    # passband the path produced
    kernel, plain = _am_case(cfg.n_chan, cfg.chunk_per_chan, gen,
                             device=device,
                             yT=(out.baseband.re, out.baseband.im),
                             n_taps=cfg.n_taps)
    _compare("chain_tail_am", f"AM time-major nf={cfg.chunk_per_chan}",
             kernel, plain, TOL_SNR_DB["tail"], device, err)
    times["chain_tail_am_time"] = (cuda_ms(kernel, iters), cuda_ms(plain, 2))
    print(f"time chain_tail_am time-major 33 taps: kernel "
          f"{times['chain_tail_am_time'][0]:.3f} ms, plain "
          f"{times['chain_tail_am_time'][1]:.3f} ms", flush=True)
    _tail_launch_info("chain_tail_am", "tmajor 33 taps", cfg.n_chan,
                      cfg.chain_cfg)
    del kernel, plain
    ccfg = wb.WidebandConfig(**dict(HEADLINE, n_taps=33),
                             **dict(wb.PROFILES["quality"],
                                    time_major=False))
    cst, _ = wb.process(ccfg, params, wb.init_state(ccfg, device=device),
                        short[0])
    _, out_c = wb.process(ccfg, params, cst, short[1])
    snr = _snr_db(out_c.audio.T, out.audio)
    bb = _snr_db(out_c.baseband.re.T, out.baseband.re)
    print(f"main path tmajor 33 taps (standalone passband): launches "
          f"{launches}; audio {tuple(out.audio.shape)}; vs chan-major tier "
          f"snr {snr:.2f} dB, baseband {bb:.2f} dB (tol "
          f"{TOL_TIER_DB['quality']} dB)", flush=True)
    if launches != want or not min(snr, bb) >= TOL_TIER_DB["quality"] \
            or not bool(torch.isfinite(out.audio).all()):
        raise AssertionError("tmajor standalone-passband branch failed")
    for k, v in launches.items():
        total[k] += v
    return {"launches": total, "times": times}


def _by_bin(audio: torch.Tensor, order) -> torch.Tensor:
    """Time-major audio [T·L, C] with its columns in PFB bin order."""
    inv = torch.as_tensor(np.argsort(np.asarray(order)), device=audio.device)
    return audio.index_select(1, inv)


def phase_mesh(device, err: dict, iters: int = 5, seed: int = 12) -> dict:
    """The sharded wideband (MESH) at HEADLINE on 8, 4 and 2 shards of the
    card (fast; quality on 8): two chained process_n calls, the first on
    two float32 chunks, the second on two int16 chunks. A chunk launches
    the channelizer, the FIR tail and the halo kernel once each; the
    counted traffic is the comm model's. The audio, by PFB bin, is the
    serial planar path's on the same factoring bit for bit (2 shards: the
    serial factoring; 4 and 8: chan_factors=(20, 128)), and so are the RSSI
    rows; and it is within TOL_TIER_DB of the serial quality path (float32
    operands, ~108 dB from the plain float32 version): the fast mesh's
    own bf16 error. Against the serial fast path on its own factoring the
    SNR is printed too: two bf16 computations rounded at other places, each
    ~47 dB from float32 in steady state, differ by ~44.5 dB (the AGC turns
    a rounding difference at a noise peak into a gain difference; CPU
    model at MID), so that pair is not held to the fast bound. Then ms a
    chunk beside serial planar, the device's idle share and where its time
    goes on 8 shards, and the mesh kernels against their plain versions at
    this shape, timed."""
    from supersdr_tpu_torch.parallel import collectives, comm_model
    from supersdr_tpu_torch.parallel import sharded_wideband as sw
    from supersdr_tpu_torch.runtime import wideband as wb
    gen = torch.Generator(device=device).manual_seed(seed)
    total = {k: 0 for k in _wrappers()}
    times = {}
    want = {**total, "channelize_fused": 2, "chain_tail": 2, "halo": 2}
    f32, i16 = _headline_inputs(wb.WidebandConfig(**HEADLINE), gen, device)
    calls = (("f32", f32), ("i16", i16))
    serial = {}

    def reference(prof, factors=None):
        """The serial planar path on the calls (chan_factors `factors`):
        per call, the audio of each chunk and the RSSI rows of the last,
        by PFB bin."""
        if (prof, factors) not in serial:
            cfg = wb.WidebandConfig(**HEADLINE, chan_factors=factors,
                                    **wb.PROFILES[prof])
            params = wb.make_params(cfg, device=device)
            order = wb.audio_channel_order(cfg)
            st, runs = wb.init_state(cfg, device=device), []
            for _, chunks in calls:
                outs = []
                for c in chunks:
                    st, o = wb.process(cfg, params, st, c)
                    outs.append(_by_bin(o.audio, order))
                runs.append((outs, o.rssi[np.argsort(order)]))
            serial[prof, factors] = runs
        return serial[prof, factors]

    for prof, shards in (("fast", MESH_SHARDS), ("quality", (MESH_D,))):
        cfg = wb.WidebandConfig(**HEADLINE, **wb.PROFILES[prof])
        params = wb.make_params(cfg, device=device)
        for d in shards:
            proc = sw.build(cfg, sw.make_mesh(d, device))
            n1, n2, _ = proc.planar_factors
            same_fac = reference(prof, None if d == 2 else (n1, n2))
            accurate = reference("quality")
            own = reference(prof)
            st = wb.init_state(cfg, device=device)
            for c, (kind, chunks) in enumerate(calls):
                _reset_counts()
                collectives.traffic.reset()
                st, outs, rssi = proc.process_n(params, st, chunks)
                _sync(device)
                launches = _counts()
                moved = collectives.traffic.total_bytes
                model = comm_model.wideband_comm_model(
                    cfg, d, i16=kind == "i16")["total_bytes"] * len(chunks)
                for k, v in launches.items():
                    total[k] += v
                same, snr_acc, snr_own = True, [], []
                for k, a in enumerate(outs):
                    got = _by_bin(a, proc.channel_order)
                    same = same and torch.equal(got, same_fac[c][0][k])
                    snr_acc.append(_snr_db(accurate[c][0][k], got))
                    snr_own.append(_snr_db(own[c][0][k], got))
                finite = all(bool(torch.isfinite(a).all()) for a in outs)
                r_err = float((rssi[np.argsort(proc.channel_order)]
                               - same_fac[c][1]).abs().max())
                print(f"mesh {prof} {d} shards {proc.planar_factors} {kind}: "
                      f"launches {launches} for {len(chunks)} chunks; "
                      f"traffic {moved} bytes (model {model}); audio "
                      f"{tuple(outs[0].shape)} finite={finite}; bit-identical"
                      f" to serial planar on ({n1}, {n2}) {same}, RSSI max "
                      f"|diff| {r_err:.2e} dB; snr vs serial quality "
                      f"{' / '.join(f'{x:.2f}' for x in snr_acc)} dB (tol "
                      f"{TOL_TIER_DB[prof]} dB), vs serial {prof} "
                      f"{' / '.join(f'{x:.2f}' for x in snr_own)} dB",
                      flush=True)
                if launches != want or moved != model or not finite \
                        or not same or r_err > 0.05 \
                        or not min(snr_acc) >= TOL_TIER_DB[prof]:
                    raise AssertionError(f"mesh {prof} {d} shards {kind} "
                                         f"failed")
                del outs
    serial.clear()
    torch.cuda.empty_cache()
    for prof, shards in (("fast", MESH_SHARDS), ("quality", (MESH_D,))):
        cfg = wb.WidebandConfig(**HEADLINE, **wb.PROFILES[prof])
        params = wb.make_params(cfg, device=device)
        # ms a chunk beside serial planar, float32 (int16 on 8 shards)
        hold = {}
        steps = {}
        for d in shards:
            proc = sw.build(cfg, sw.make_mesh(d, device))
            for kind, chunks in calls:
                if kind == "i16" and d != MESH_D:
                    continue
                key = f"mesh{d}_{kind}"
                hold[key] = wb.init_state(cfg, device=device)

                def step(proc=proc, chunks=chunks, key=key):
                    hold[key], outs, _ = proc.process_n(params, hold[key],
                                                        chunks)
                    return outs[-1].abs().mean()
                steps[key] = step
        hold["serial"] = wb.init_state(cfg, device=device)

        def serial_step():
            hold["serial"], outs = wb.process_n(cfg, params, hold["serial"],
                                                f32)
            return outs[-1].abs().mean()
        steps["serial_f32"] = serial_step
        # two rounds, the second in reverse order (a drift of the card or
        # of the host shows as a spread); a warm-up call each first
        for fn in steps.values():
            fn()
        got = {key: [] for key in steps}
        for rnd in range(2):
            for key in (list(steps) if rnd == 0 else list(steps)[::-1]):
                got[key].append(cuda_ms(steps[key], iters) / 2)
        for key, ms in got.items():
            times[f"mesh_{prof}_{key}"] = sum(ms) / len(ms)
            print(f"time mesh {prof} {key}: "
                  f"{' / '.join(f'{m:.3f}' for m in ms)} ms/chunk, "
                  f"{cfg.chunk_in / (min(ms) * 1e-3) / 1e6:.1f} Msamples/s "
                  f"input at the faster", flush=True)
        device_share(f"mesh {prof} {MESH_D} shards f32 (2 chunks a call)",
                     steps[f"mesh{MESH_D}_f32"], calls=3, rows=12)
        del steps, hold
        torch.cuda.empty_cache()
        # the mesh kernels at this shape, against their plain versions
        (ck, cp), (tk, tp) = _mesh_kernel_cases(cfg, params, gen,
                                                device=device, err=err,
                                                label="HEADLINE")
        times[f"mesh_channelize_fused_{prof}"] = (cuda_ms(ck, iters),
                                                  cuda_ms(cp, 2))
        times[f"mesh_chain_tail_{prof}"] = (cuda_ms(tk, iters),
                                            cuda_ms(tp, 2))
        for name in ("channelize_fused", "chain_tail"):
            k_ms, p_ms = times[f"mesh_{name}_{prof}"]
            print(f"time {name} {prof} mesh: kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms", flush=True)
        del ck, cp, tk, tp
        torch.cuda.empty_cache()
    return {"launches": total, "times": times}


def phase_mesh_tiers(device, seed: int = 13) -> dict:
    """The sharded wideband's other tiers at MID on 8 shards, each against
    the same two chained calls on the CPU (≥ TOL_SNR_DB["cpu"]): the
    time-major tier (the fast profile with planar_waste_max=0: the
    channelizer's time store, the all_to_all over channels, the FIR tail
    on the shards' planes; and with a 33-tap passband: the time-major
    Toeplitz passband and the non-FIR tail) and the fallback tier
    (CHANMAJOR: the fold kernel over the shards, the all_to_all, the
    chain's tail kernel). Launch counts a chunk as the tier's."""
    from supersdr_tpu_torch.parallel import sharded_wideband as sw
    from supersdr_tpu_torch.runtime import wideband as wb
    rng = np.random.default_rng(seed)
    cpu = torch.device("cpu")
    total = {k: 0 for k in _wrappers()}
    cases = (
        ("tmajor", dict(MID, **wb.PROFILES["fast"]), 0.0,
         {"channelize_fused": 1, "chain_tail": 1, "halo": 1}),
        ("tmajor 33 taps", dict(MID, n_taps=33, **wb.PROFILES["quality"]),
         None, {"channelize_fused": 1, "chain_tail_am": 1, "halo": 1}),
        ("fallback", dict(MID, **CHANMAJOR), None,
         {"pfb_fold": 1, "chain_tail_am_c": 1, "halo": 1}))
    for label, kw, wmax, per_chunk in cases:
        cfg = wb.WidebandConfig(**kw)
        chunks = [((rng.normal(size=cfg.chunk_in)
                    + 1j * rng.normal(size=cfg.chunk_in)) * 0.05
                   ).astype(np.complex64) for _ in range(2)]
        res = {}
        for key, dev in (("card", device), ("cpu", cpu)):
            proc = sw.build(cfg, sw.make_mesh(MESH_D, dev),
                            planar_waste_max=wmax)
            p = wb.make_params(cfg, device=dev)
            st = wb.init_state(cfg, device=dev)
            _reset_counts()
            audio = []
            for c in chunks:
                st, a, _ = proc(p, st, c)
                audio.append(a.cpu().numpy())
            _sync(dev)
            res[key] = (np.stack(audio), _counts(), proc.tier)
        launches = res["card"][1]
        want = {**{k: 0 for k in launches},
                **{k: v * len(chunks) for k, v in per_chunk.items()}}
        print(f"mesh tier {label} ({res['card'][2]}) MID {MESH_D} shards: "
              f"launches {launches}", flush=True)
        if launches != want or res["card"][2] != label.split()[0]:
            raise AssertionError(f"mesh tier {label} missed a kernel")
        for k, v in launches.items():
            total[k] += v
        _close_to_cpu(f"mesh tier {label} MID", res["card"][0],
                      res["cpu"][0], TOL_SNR_DB["cpu"])
    return {"launches": total}


def phase_mesh_parts(device, seed: int = 14) -> None:
    """The other mesh forms on the card: the distributed FFT (8 shards,
    2^22 points) against torch.fft.fft (≤ 1e-4 of the largest bin), the
    2-stage pipeline (two MID microbatches, chan-major with the tail
    kernel) against the serial wideband on the card, and the dry run of
    every mesh form on 8 shards."""
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.parallel import dist_fft, dryrun, pipeline
    from supersdr_tpu_torch.runtime import wideband as wb
    gen = torch.Generator(device=device).manual_seed(seed)
    n = 1 << 22
    x = torch.randn(n, generator=gen, device=device, dtype=torch.complex64)
    y = dist_fft.build_fft(n, dist_fft.make_mesh(MESH_D, device))(x)
    want = torch.fft.fft(x)
    rel = float((torch.complex(y.re, y.im) - want).abs().max()
                / want.abs().max())
    print(f"dist_fft {MESH_D} shards n={n}: max error {rel:.2e} of the "
          f"largest bin (tol 1e-4)", flush=True)
    if not rel <= 1e-4:
        raise AssertionError("dist_fft disagrees with torch.fft.fft")
    cfg = wb.WidebandConfig(**dict(MID, time_major=False, tail_impl="pallas",
                                   passband_impl="fft"))
    p = wb.make_params(cfg, device=device)
    mbs = cx.CX(*(torch.randn(2, cfg.chunk_in, generator=gen, device=device)
                  * 0.05 for _ in range(2)))
    _reset_counts()
    _, audio = pipeline.build(cfg, pipeline.make_mesh(device))(
        p, wb.init_state(cfg, device=device), mbs)
    launches = _counts()
    _, outs = wb.process_n(cfg, p, wb.init_state(cfg, device=device),
                           [cx.CX(mbs.re[i], mbs.im[i]) for i in range(2)])
    snr = min(_snr_db(o, a) for o, a in zip(outs, audio))
    print(f"pipeline 2 stages, 2 MID microbatches: audio "
          f"{tuple(audio.shape)}, launches {launches}, vs serial snr "
          f"{snr:.2f} dB (tol {TOL_SNR_DB['cpu']} dB)", flush=True)
    if launches["chain_tail_am_c"] != 2 or not snr >= TOL_SNR_DB["cpu"]:
        raise AssertionError("pipeline disagrees with the serial wideband")
    print(dryrun.dryrun_multichip(MESH_D, device), flush=True)

# the transport across processes on the one card: ranks spawned by
# `parallel.launch.spawn`, every one on the card, joined by a gloo group.
# PROCS_D time shards over 2 and 4 processes; the halo's SHARDED passband
# exchange (8 receivers × 131072 complex samples a shard, 256 of history)
PROCS_D = 8
PROCS_WORLDS = (2, 4)
PROCS_DELAY_CYCLES = 40_000_000       # ~20 ms of one SM's clock


def _procs_inputs(device, seed: int = 21) -> dict:
    """The primitives' global inputs on PROCS_D shards, the same in every
    process (a seeded CPU generator, then the card)."""
    g = torch.Generator().manual_seed(seed)
    D = PROCS_D

    def f32(*shape):
        return torch.randn(shape, generator=g).to(device)

    def i16(*shape):
        return (torch.randn(shape, generator=g) * 3000).to(
            torch.int16).to(device)
    return {
        "halo": torch.complex(f32(8, D, 4096), f32(8, D, 4096)),
        "head": torch.complex(f32(8, 256), f32(8, 256)),
        "f32": f32(64, D, 512), "head_f32": f32(64, 16),
        "pair": (i16(2, 4, D, 256), i16(2, 4, D, 256)),
        "ctx": f32(16, D, 64), "summary": f32(16, D, 1),
        "a2a": f32(D, 48, 32).to(torch.bfloat16), "bcast": f32(D, 7),
        "send": f32(D, 5, 3),
        "state": (f32(8), f32(8, 256), f32(8, 3).to(torch.int16)),
    }


def _procs_prims(comm, x: dict) -> dict:
    """Every primitive through `comm` on its process's block of `x`."""
    def block(t, axis):
        d = t.shape[axis] // comm.world
        return t.narrow(axis, comm.rank * d, d)
    out = {
        "halo": comm.left_halo(block(x["halo"], -2), 256, head0=x["head"]),
        "halo_f32": comm.left_halo(block(x["f32"], -2), 16, 0.5,
                                   head0=x["head_f32"]),
        "pair": comm.left_halo(tuple(block(p, -2) for p in x["pair"]), 9,
                               -3.0),
        # 300 samples of 64-sample shards: five hops, across ranks
        "context": comm.left_context(block(x["ctx"], -2), 300, -torch.inf),
        "summaries": comm.gather_summaries(block(x["summary"], -2)),
        "index": comm.shard_index(block(x["summary"], -2)),
        "a2a_01": comm.all_to_all(block(x["a2a"], 0), 0, 1),
        "a2a_10": comm.all_to_all(block(x["a2a"], 0), 1, 0),
        "bcast": comm.broadcast_last(block(x["bcast"], 0)),
        "send": comm.send_next(block(x["send"], 0)),
    }
    return {k: (torch.stack(v) if isinstance(v, tuple) else v)
            for k, v in out.items()}


def _procs_blocks(comm, want: dict) -> dict:
    """This process's block of the one-process results."""
    def block(t, axis):
        d = t.shape[axis] // comm.world
        return t.narrow(axis, comm.rank * d, d)
    axes = {"halo": -2, "halo_f32": -2, "pair": -2, "context": -2,
            "index": 0, "a2a_01": 0, "a2a_10": 0, "bcast": 0, "send": 0}
    return {k: (block(v, axes[k]) if k in axes else v)
            for k, v in want.items()}


def _proc_prims(rank: int, world: int, dev) -> dict:
    """Each primitive through the process transport on the card, "rdma"
    (the halo kernel with peer destinations) and "ppermute" (copy_ into
    the peers' buffers), against the plain version on the whole tensors in
    this process (the one-process transport with plain halos,
    `left_halo_plain`): bit for bit. Also `replicate` and `gather`.
    Returns the halo kernel's launches and how many had peers."""
    from supersdr_tpu_torch.ops.cuda import halo
    from supersdr_tpu_torch.parallel import collectives, mesh
    x = _procs_inputs(dev)
    comm = mesh.time_mesh(PROCS_D, device=dev).comm
    if comm.world != world:
        raise AssertionError(f"the mesh holds {comm.world} processes, "
                             f"not {world}")
    want = _procs_blocks(comm, _procs_prims(collectives.Transport("ppermute"),
                                            x))
    n_cases, launches = 0, 0
    for impl in ("rdma", "ppermute"):
        before = halo.left_halo.launches
        got = _procs_prims(comm.using(impl), x)
        torch.cuda.synchronize()
        launches += halo.left_halo.launches - before
        for k, w in want.items():
            g = got[k]
            if g.shape != w.shape or not torch.equal(
                    torch.view_as_real(g) if g.is_complex() else g,
                    torch.view_as_real(w) if w.is_complex() else w):
                raise AssertionError(f"rank {rank}/{world} {impl} {k} "
                                     f"differs from the plain version")
            n_cases += 1
    mine = tuple(v + rank for v in x["state"])
    rep = comm.replicate(mine)
    last = tuple(v + (world - 1) for v in x["state"])
    gat = comm.gather(x["f32"].narrow(-2, rank, 1), -2)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(rep, last)) \
            or not torch.equal(gat, x["f32"][:, :world]):
        raise AssertionError(f"rank {rank}/{world} replicate or gather "
                             f"differs")
    # rdma: halo launches 3 (halo, halo_f32, pair) + 5 (context hops);
    # ppermute: none. Every rank launches; all but the last push to a peer
    want_launches = 3 + 5
    if launches != want_launches:
        raise AssertionError(f"rank {rank}/{world}: {launches} halo "
                             f"launches, want {want_launches}")
    return {"cases": n_cases + 2, "launches": launches}


def _proc_delay(rank: int, world: int, dev, rounds: int = 8) -> dict:
    """Ordering under delay: `rounds` halo calls of the halo kernel across
    the processes, queued with no host synchronisation between them (so
    each receive slot is written four times while the streams fall
    behind), one rank held back by `torch.cuda._sleep` inside each round:
    in the first half a receiver between its wait and its read (only its
    senders' wait on its "read_done" keeps their push two rounds later off
    the slot it has yet to read), in the second half a sender before its
    push (only the receiver's wait on its "pushed" keeps the read after
    it). Then every round's output, bit for bit, against the plain version
    on the whole input of that round. Returns the ms the host took to queue
    the rounds and the ms until the card had run them."""
    from supersdr_tpu_torch.parallel import collectives, mesh
    comm = mesh.time_mesh(PROCS_D, device=dev).comm
    plain = collectives.Transport("ppermute")
    x = _procs_inputs(dev)
    d = PROCS_D // world
    ys = [x["halo"] * (k + 1) + k for k in range(rounds)]
    heads = [x["head"] - k for k in range(rounds)]
    mine = [y[:, rank * d:(rank + 1) * d].contiguous() for y in ys]
    comm.left_halo(mine[0], 256, head0=heads[0])   # maps the buffers
    torch.cuda.synchronize()
    slots = comm._slots()
    held = slots.round
    late = [(1 + k % (world - 1), "pull") if k < rounds // 2
            else (k % (world - 1), "push") for k in range(rounds)]
    k = 0

    def held_back(dsts, srcs, push, pull):
        who, where = late[k]

        def push_():
            if (rank, "push") == (who, where):
                torch.cuda._sleep(PROCS_DELAY_CYCLES)
            push()

        def pull_():
            if (rank, "pull") == (who, where):
                torch.cuda._sleep(PROCS_DELAY_CYCLES)
            pull()
        held(dsts, srcs, push_, pull_)
    slots.round = held_back
    got = []
    t0 = time.perf_counter()
    try:
        for k in range(rounds):
            got.append(comm.left_halo(mine[k], 256, head0=heads[k]))
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        ran_ms = (time.perf_counter() - t0) * 1e3
    finally:
        slots.round = held
    for k in range(rounds):
        want = plain.left_halo(ys[k], 256, head0=heads[k])
        if not torch.equal(torch.view_as_real(got[k]), torch.view_as_real(
                want[:, rank * d:(rank + 1) * d])):
            raise AssertionError(f"rank {rank}/{world}: round {k}, rank "
                                 f"{late[k][0]} late at its "
                                 f"{late[k][1]}, differs from the plain "
                                 f"version")
    return {"rounds": rounds, "queued_ms": queued_ms, "ran_ms": ran_ms}


def _proc_halo_time(rank: int, world: int, dev, iters: int = 200) -> dict:
    """The halo kernel across processes at SHARDED's passband exchange
    (8 receivers × d_local shards of 131072 complex samples, 256 of
    history, the carry as global shard 0's head): µs a call as the host
    sees it (every rank, synchronised at the end) and as the card sees it
    (CUDA events around the same calls: the round's waits on the peers
    included); the host handshake alone (a bare barrier of the gloo
    group); and, on rank 0 while the others wait, the push launch alone
    with its peer destinations, the launches queued (`cuda_ms_queued`)."""
    import torch.distributed as dist
    from supersdr_tpu_torch.ops.cuda import halo
    from supersdr_tpu_torch.parallel import mesh
    comm = mesh.time_mesh(PROCS_D, device=dev).comm
    n = SHARDED["n_taps"] - 1
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(SHARDED_RX, PROCS_D // world, SHARDED["chunk"],
                    generator=g, device=dev, dtype=torch.complex64)
    head = torch.randn(SHARDED_RX, n, generator=g, device=dev,
                       dtype=torch.complex64)
    out = torch.empty(SHARDED_RX, PROCS_D // world, n, dtype=torch.complex64,
                      device=dev)
    for _ in range(5):
        comm._halo(x, n, 0.0, 1, head, out)
    torch.cuda.synchronize()
    dist.barrier()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        comm._halo(x, n, 0.0, 1, head, out)
    end.record()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        dist.barrier()
    barrier_us = (time.perf_counter() - t0) / iters * 1e6
    slots = comm._slots()

    def push():
        box = slots.outbox(1)[:out.numel() * 8].view(torch.complex64)
        peer = torch.as_strided(box, out.shape, out.stride())
        halo.left_halo(x, n, head0=head, out=out, peers=[(peer, 0)])
    kernel_us = _alone(rank, lambda: cuda_ms_queued(push, iters, dev) * 1e3)
    return {"host_us": host_us,
            "card_us": start.elapsed_time(end) / iters * 1e3,
            "barrier_us": barrier_us, "kernel_us": kernel_us}


def _timed_calls(step, iters: int) -> float:
    """ms a call of step() from the host, the card synchronised at the
    end, after a warm-up call; every rank together."""
    import torch.distributed as dist
    step()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    dist.barrier()
    return ms


def _alone(rank: int, fn):
    """fn() on rank 0 while the other ranks wait (one process's time on
    the card, nothing else on it); None elsewhere."""
    import torch.distributed as dist
    got = fn() if rank == 0 else None
    dist.barrier()
    return got


def _proc_sharded(rank: int, world: int, dev, iters: int = 5) -> dict:
    """SHARDED (8 receivers × 8 time shards × 131072 samples, AM, matmul
    passband) over the processes: two chained calls from zeroed launch
    counts, this rank's audio against the same calls of the one-process
    mesh on the card (bit for bit, or ≥ TOL_SNR_DB["cpu"]); then ms a call
    over the processes and of one process alone."""
    from supersdr_tpu_torch.parallel import ingest, mesh, sharded_chain
    from supersdr_tpu_torch.runtime import chain
    cfg = chain.ChainConfig(**SHARDED)
    n = cfg.chunk * SHARDED_D
    offs = np.linspace(-300.0, 300.0, SHARDED_RX)
    agc_on = dict(on=True, thresh_db=-80, decay_ms=1000)
    iq = _sharded_iq(SHARDED_RX, 2 * n, cfg.iq_rate, 9)
    calls = [iq[:, :n], iq[:, n:]]
    runs = {}
    for key, world_ in (("procs", None), ("one", 1)):
        m = mesh.time_mesh(SHARDED_D, device=dev, world=world_)
        proc = sharded_chain.build(cfg, m)
        p = sharded_chain.make_params(cfg, SHARDED_RX, offs,
                                      agc_kwargs=agc_on, device=dev)
        st = sharded_chain.init_state(cfg, SHARDED_RX, device=dev)
        lo, hi = ingest.local_time_range(n, m)
        if key == "procs":
            _reset_counts()
        outs = []
        for c in calls:
            blk = ingest.make_global_iq(c[:, lo:hi], c.shape, m)
            st, out = proc(p, st, blk.flatten(-2))
            outs.append(out.audio)
        torch.cuda.synchronize()
        if key == "procs":
            launches = _counts()
        runs[key] = (proc, p, st, torch.cat(outs, dim=-1), m, lo, hi)
    audio, one = runs["procs"][3], runs["one"][3]
    w = one.shape[-1] // 2 // world          # this rank's part of a call
    mine = torch.cat([one[:, k * w * world + rank * w:][:, :w]
                      for k in range(2)], dim=-1)
    same = torch.equal(audio, mine)
    snr = _snr_db(mine, audio)
    if launches["halo"] != 3 * len(calls) or not (same or snr >= TOL_SNR_DB[
            "cpu"]) or not bool(torch.isfinite(audio).all()):
        raise AssertionError(f"rank {rank}/{world}: SHARDED over processes "
                             f"launches {launches}, identical {same}, snr "
                             f"{snr:.2f} dB")
    x = {}
    for key in ("procs", "one"):
        proc, p, st, _, m, lo, hi = runs[key]
        x[key] = torch.as_tensor(calls[0][:, lo:hi], device=dev)
    hold = {k: runs[k][2] for k in runs}

    def step(key):
        proc, p = runs[key][0], runs[key][1]
        hold[key], out = proc(p, hold[key], x[key])
        return out.audio.abs().mean()
    ms = _timed_calls(lambda: step("procs"), iters)
    one_ms = _alone(rank, lambda: cuda_ms(lambda: step("one"), iters))
    return {"launches": launches, "same": same, "snr": snr, "ms": ms,
            "one_ms": one_ms}


def _proc_mesh(rank: int, world: int, dev, iters: int = 3,
               seed: int = 12) -> dict:
    """HEADLINE fast through `sharded_wideband` on MESH_D shards over the
    processes: two chained process_n calls of two chunks (float32, then
    int16) from zeroed launch counts, the audio gathered from the ranks'
    rows against the one-process MESH_D-shard mesh on the card (bit for
    bit, or ≥ TOL_TIER_DB["fast"]), column for column (both keep
    `channel_order`); then ms a chunk over the processes and of one
    process alone."""
    from supersdr_tpu_torch.parallel import sharded_wideband as sw
    from supersdr_tpu_torch.runtime import wideband as wb
    from supersdr_tpu_torch.utils import held
    cfg = wb.WidebandConfig(**HEADLINE, **wb.PROFILES["fast"])
    params = wb.make_params(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32, i16 = _headline_inputs(cfg, gen, dev)
    procs = {"procs": sw.build(cfg, sw.make_mesh(MESH_D, dev)),
             "one": sw.build(cfg, sw.make_mesh(MESH_D, dev, world=1))}
    got = {}
    for key, proc in procs.items():
        st = proc.local_state(wb.init_state(cfg, device=dev))
        if key == "procs":
            _reset_counts()
        outs = []
        for chunks in (f32, i16):
            st, audio, rssi = proc.process_n(params, st, chunks)
            outs += [proc.gather_rows(a, 1) for a in audio]
            outs.append(proc.gather_rows(rssi, 0))
        torch.cuda.synchronize()
        if key == "procs":
            launches = _counts()
            full = proc.gather_state(st)
        got[key] = (outs, st if key == "one" else full)
    same = all(torch.equal(a, b) for a, b in zip(got["procs"][0],
                                                  got["one"][0]))
    snr = min(_snr_db(b, a) for a, b in zip(got["procs"][0][:2],
                                             got["one"][0][:2]))
    state_same = all(torch.equal(a, b) for a, b in zip(
        held.leaves(got["procs"][1]), held.leaves(got["one"][1])))
    want = {**{k: 0 for k in _wrappers()}, "channelize_fused": 4,
            "chain_tail": 4, "halo": 4}
    if launches != want or not (same or snr >= TOL_TIER_DB["fast"]) \
            or not state_same:
        raise AssertionError(f"rank {rank}/{world}: MESH over processes "
                             f"launches {launches}, identical {same}, snr "
                             f"{snr:.2f} dB, state identical {state_same}")
    del got
    hold = {k: procs[k].local_state(wb.init_state(cfg, device=dev))
            for k in procs}

    def step(key):
        hold[key], outs, _ = procs[key].process_n(params, hold[key], f32)
        return outs[-1].abs().mean()
    ms = _timed_calls(lambda: step("procs"), iters) / len(f32)
    one_ms = _alone(rank, lambda: cuda_ms(lambda: step("one"), iters)
                    / len(f32))
    return {"launches": launches, "same": same, "snr": snr, "ms": ms,
            "one_ms": one_ms}


_PROC_TASKS = {"prims": _proc_prims, "delay": _proc_delay,
               "halo_time": _proc_halo_time, "sharded": _proc_sharded,
               "mesh": _proc_mesh}


def _procs_worker(rank: int, world: int, tasks: tuple) -> dict:
    """One rank of phase_procs: the built library loaded (not rebuilt),
    the tasks run in order on the card."""
    from supersdr_tpu_torch import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {"jax": "jax" in sys.modules}
    for name in tasks:
        t0 = time.perf_counter()
        out[name] = _PROC_TASKS[name](rank, world, dev)
        out[name]["s"] = time.perf_counter() - t0
    return out


def phase_procs(device, tmp: str, timeout: float = 400.0) -> dict:
    """The port's mesh across processes on the one card: PROCS_WORLDS
    ranks spawned (`parallel.launch.spawn`: a gloo group over a file store;
    each rank loads the built library). In each: every primitive of
    `collectives.ProcessTransport` against the one-process transport, bit
    for bit, with the halo kernel pushing into peer buffers over CUDA IPC;
    the ordering under a delayed rank; the halo's µs a call across
    processes; SHARDED over the processes against one process. Over 2
    ranks also HEADLINE fast through `sharded_wideband` on MESH_D shards
    against the one-process mesh. Any failure in a rank fails here."""
    from supersdr_tpu_torch.parallel import launch
    torch.cuda.empty_cache()
    launches = {"sharded_procs": {k: 0 for k in _wrappers()},
                "mesh_procs": {k: 0 for k in _wrappers()}}
    times = {}
    for world in PROCS_WORLDS:
        tasks = ("prims", "delay", "halo_time", "sharded")
        if world == 2:
            tasks += ("mesh",)
        t0 = time.perf_counter()
        res = launch.spawn(_procs_worker, world,
                           os.path.join(tmp, f"procs{world}.store"), tasks,
                           timeout=timeout)
        wall = time.perf_counter() - t0
        if any(r["jax"] for r in res):
            raise AssertionError("a rank imported JAX")
        print(f"procs {world} ranks on one card: {wall:.1f} s, task s by "
              f"rank {[{t: round(r[t]['s'], 1) for t in tasks} for r in res]}"
              f"; primitives bit-identical to one process "
              f"({res[0]['prims']['cases']} cases a rank), halo launches "
              f"by rank {[r['prims']['launches'] for r in res]} (all but "
              f"the last rank pushing to a peer); ordering held over "
              f"{res[0]['delay']['rounds']} queued rounds, a rank late at its "
              f"read or its push in each (queued in "
              f"{[round(r['delay']['queued_ms'], 1) for r in res]} ms, run "
              f"by {[round(r['delay']['ran_ms'], 1) for r in res]} ms, by "
              f"rank)", flush=True)
        ht = [r["halo_time"] for r in res]
        print(f"time halo across {world} processes [{SHARDED_RX}, "
              f"{PROCS_D // world} of {PROCS_D}, 256] complex64: a call from "
              f"the host {[round(h['host_us'], 1) for h in ht]} us, on the "
              f"card (its waits on the peers included) "
              f"{[round(h['card_us'], 1) for h in ht]} us, by rank",
              flush=True)
        print(f"time halo across {world} processes: the host handshake "
              f"alone (a gloo barrier) {[round(h['barrier_us'], 1) for h in ht]}"
              f" us by rank; rank 0's push launch alone with its peer "
              f"destination, queued on the card, {ht[0]['kernel_us']:.2f} us",
              flush=True)
        times[f"halo_procs{world}"] = (max(h["host_us"] for h in ht),
                                       max(h["card_us"] for h in ht),
                                       max(h["barrier_us"] for h in ht),
                                       ht[0]["kernel_us"])
        sh = [r["sharded"] for r in res]
        print(f"procs SHARDED over {world} ranks: launches by rank "
              f"{[s['launches']['halo'] for s in sh]} halo, identical to one "
              f"process {[s['same'] for s in sh]}, snr "
              f"{[round(s['snr'], 2) for s in sh]} dB; "
              f"{max(s['ms'] for s in sh):.3f} ms/call over {world} "
              f"processes against {sh[0]['one_ms']:.3f} ms/call in one",
              flush=True)
        times[f"sharded_procs{world}"] = (max(s["ms"] for s in sh),
                                          sh[0]["one_ms"])
        for s in sh:
            for k, v in s["launches"].items():
                launches["sharded_procs"][k] += v
        if world == 2:
            me = [r["mesh"] for r in res]
            print(f"procs MESH fast {MESH_D} shards over {world} ranks: "
                  f"launches by rank {[m['launches'] for m in me]}, audio "
                  f"and RSSI identical to one process "
                  f"{[m['same'] for m in me]}, snr "
                  f"{[round(m['snr'], 2) for m in me]} dB; "
                  f"{max(m['ms'] for m in me):.3f} ms/chunk over {world} "
                  f"processes against {me[0]['one_ms']:.3f} ms/chunk in one",
                  flush=True)
            times["mesh_procs2"] = (max(m["ms"] for m in me),
                                    me[0]["one_ms"])
            for m in me:
                for k, v in m["launches"].items():
                    launches["mesh_procs"][k] += v
    return {"paths": {k: {"launches": v} for k, v in launches.items()},
            "times": times}

# the CLI and live-session phases. WIDE: a 30.72 MHz capture into 2560
# channels, 11904 frames (0.992 s), which both profiles' chan_tile_t
# divide, so `cli wideband --profile` takes the planar tier; the MID capture
# (512 frames) runs the same call on the card and on the CPU
CLI_CARRIERS = ((3, 700.0), (311, 900.0), (777, 1100.0), (1290, 1300.0),
                (1801, 1500.0), (2400, 1700.0))   # (channel, AM tone Hz)
CLI_WIDE_FRAMES, CLI_MID_FRAMES = 11904, 512
# card against CPU on the CLI's int16 WAVs: the quality tier and the plain
# chain are float32-class (≥ 80 dB before the int16 rounding, which leaves
# a code of difference here and there); the fast tier rounds to bf16 at
# other places (TOL_TIER_DB)
TOL_WAV_DB = {"quality": 75.0, "fast": TOL_TIER_DB["fast"], None: 75.0}
SESSION_CHUNKS = 256


def _wide_capture_dev(n: int, fs: int, n_chan: int, device,
                      seed: int = 21) -> torch.Tensor:
    """n samples at fs, complex64 on the card: AM carriers at the centres
    of CLI_CARRIERS' channels over a noise floor far below them."""
    from supersdr_tpu_torch.ops import channelizer
    plan = channelizer.PFBPlan(n_chan=n_chan, taps_per=8, hop=n_chan)
    freqs = channelizer.channel_center_freqs(plan, fs)
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n, device=device, dtype=torch.float64) / fs
    z = torch.complex(torch.randn(n, generator=gen, device=device),
                      torch.randn(n, generator=gen, device=device)) * 1e-4
    for ch, tone in CLI_CARRIERS:
        env = 0.05 * (1.0 + 0.5 * torch.cos(2 * np.pi * tone * t))
        ph = torch.remainder(2 * np.pi * float(freqs[ch]) * t, 2 * np.pi)
        z = z + (env * torch.exp(1j * ph)).to(torch.complex64)
    return z


def _wide_capture(n: int, fs: int, n_chan: int, device,
                  seed: int = 21) -> np.ndarray:
    """`_wide_capture_dev` on the host."""
    return _wide_capture_dev(n, fs, n_chan, device, seed).cpu().numpy()


def _wav_snr(a_path, b_path) -> float:
    from supersdr_tpu_torch.io import wav
    a, ra = wav.read_audio_wav(a_path)
    b, rb = wav.read_audio_wav(b_path)
    if ra != rb or a.shape != b.shape:
        raise AssertionError(f"{a_path} and {b_path} differ in shape")
    return _snr_db(torch.from_numpy(a.astype(np.float64)),
                   torch.from_numpy(b.astype(np.float64)))


def _png_palette_index(path) -> np.ndarray:
    """A PNG of the port's writer (filter 0 rows) as palette indices."""
    import zlib
    from supersdr_tpu_torch.display import colormap
    raw = open(path, "rb").read()
    w, h = (int(v) for v in np.frombuffer(raw[16:24], ">u4"))
    pos, idat = 8, b""
    while pos < len(raw):
        n = int.from_bytes(raw[pos:pos + 4], "big")
        if raw[pos + 4:pos + 8] == b"IDAT":
            idat += raw[pos + 8:pos + 8 + n]
        pos += 12 + n
    rgb = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    rgb = rgb[:, 1:].reshape(h, w, 3).astype(int)
    pal = colormap.get_palette("cutesdr").astype(int)
    return np.argmin(np.abs(rgb[..., None, :] - pal).sum(-1), axis=-1)


class _CliClock:
    """Wall time of the wideband CLI's parts: the WAV read, `process` (the
    chunk's upload included, up to the card's finish), the WAV writes; and
    the config it built. The rest of the wall is the audio's copy back and
    the host's ranking."""

    def __init__(self):
        from supersdr_tpu_torch.io import wav
        from supersdr_tpu_torch.runtime import wideband as wb
        self.wav, self.wb = wav, wb
        self.t = {"read": 0.0, "process": 0.0, "write": 0.0}
        self.chunks, self.cfg = 0, None

    def _timed(self, key, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if key == "process":
                self.cfg = a[0]
                self.chunks += 1
                torch.cuda.synchronize()
            self.t[key] += time.perf_counter() - t0
            return out
        return call

    def __enter__(self):
        self._saved = (self.wav.read_kiwi_iq_wav, self.wb.process,
                       self.wav.AudioRecorder.save)
        self.wav.read_kiwi_iq_wav = self._timed("read", self._saved[0])
        self.wb.process = self._timed("process", self._saved[1])
        self.wav.AudioRecorder.save = self._timed("write", self._saved[2])
        return self

    def __exit__(self, *exc):
        (self.wav.read_kiwi_iq_wav, self.wb.process,
         self.wav.AudioRecorder.save) = self._saved

    def tier(self) -> str:
        wb, cfg = self.wb, self.cfg
        if not cfg.time_major:
            return "chan-major"
        if wb._planar_active(cfg):
            return "planar"
        return "time-major" if wb._tmajor_fused_ok(cfg) else "fallback"


class _PlainKernels:
    """The channelizer's and both tails' launches swapped for their plain
    versions on the same card tensors, so a whole CLI call gives the
    reference its kernels' run is held against."""

    def __enter__(self):
        from supersdr_tpu_torch.ops.cuda import chain_tail as ct
        from supersdr_tpu_torch.ops.cuda import channelize_fused as cf
        self._mods = (cf, ct)
        self._saved = (cf._launch, ct._launch_fir, ct._launch_am,
                       ct._launch_am_c)
        cf._launch = cf.channelize_fused_plain
        ct._launch_fir, ct._launch_am = (ct.chain_tail_plain,
                                         ct.chain_tail_am_plain)
        ct._launch_am_c = lambda y, *a, **kw: ct.chain_tail_am_plain(
            y.real.T, y.imag.T, *a, audio_layout="chan", **kw)
        return self

    def __exit__(self, *exc):
        cf, ct = self._mods
        (cf._launch, ct._launch_fir, ct._launch_am,
         ct._launch_am_c) = self._saved


def _carrier_names(cfg) -> list:
    """The file names `cli wideband` gives CLI_CARRIERS' channels under
    cfg: each output row is named by its index and its centre frequency,
    and the tier sets which row holds which channel."""
    from supersdr_tpu_torch.ops import channelizer
    from supersdr_tpu_torch.runtime import wideband as wb
    freqs = wb.channel_freqs(cfg)
    centres = channelizer.channel_center_freqs(wb.pfb_plan(cfg), cfg.fs_in)
    names = []
    for ch, _ in CLI_CARRIERS:
        row = int(np.argmin(np.abs(freqs - centres[ch])))
        if abs(freqs[row] - centres[ch]) > 1.0:
            raise AssertionError(f"no output row at channel {ch}")
        names.append(f"chan_{row:03d}_{freqs[row] / 1000:+.1f}kHz.wav")
    return sorted(names)


def _check_names(label: str, odir: str, want: list) -> list:
    got = sorted(os.listdir(odir))
    if got != want:
        raise AssertionError(f"{label} wrote {got}, not the carriers' "
                             f"channels {want}")
    return got


def _cli(argv) -> None:
    from supersdr_tpu_torch import cli
    rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")


def phase_cli(device, tmp: str) -> dict:
    """The port's CLI on the card through `cli.main` (no --device: the card
    by default), on WAVs written by the port's `io/wav`: `demod` on the
    off-air-style fixture and on a 20.25 kHz USB capture, `waterfall` on
    the fixture, each against the same call with --device cpu; `wideband
    --n-chan 2560 --profile fast|quality` on a 0.992 s capture at 30.72
    MHz (the tier, each kernel's launches from a zeroed count, the wall
    split into read / process / writes), and the same calls at MID on the
    card and on the CPU."""
    from supersdr_tpu_torch.io import wav
    out = {}
    fixture = "tests/fixtures/kiwi_am_offair_12k.wav"
    usb = os.path.join(tmp, "usb_20k25.wav")
    fs = 20_250
    t = np.arange(fs * 4) / fs
    rng = np.random.default_rng(22)
    wav.write_kiwi_iq_wav(usb, (0.2 * np.exp(2j * np.pi * 1000 * t)
                                + 0.003 * (rng.normal(size=t.size) + 1j
                                           * rng.normal(size=t.size))
                                ).astype(np.complex64), fs)
    for label, src, opts in (("demod AM off-air fixture", fixture,
                              ["--mode", "AM"]),
                             ("demod USB 20.25 kHz", usb, ["--mode", "USB"])):
        paths = {}
        for key, extra in (("card", []), ("cpu", ["--device", "cpu"])):
            paths[key] = os.path.join(tmp, f"{key}_demod.wav")
            _cli(["demod", src, "-o", paths[key], *opts, *extra])
        snr = _wav_snr(paths["cpu"], paths["card"])
        print(f"cli {label}: card vs cpu {snr:.2f} dB (tol "
              f"{TOL_WAV_DB[None]} dB)", flush=True)
        if not snr >= TOL_WAV_DB[None]:
            raise AssertionError(f"cli {label} disagrees with the CPU")
    pngs = {}
    for key, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        pngs[key] = os.path.join(tmp, f"{key}_wf.png")
        _cli(["waterfall", fixture, "-o", pngs[key], "--avg", "10", *extra])
    a, b = (_png_palette_index(pngs[k]) for k in ("cpu", "card"))
    same = float(np.mean(a == b)) if a.shape == b.shape else 0.0
    print(f"cli waterfall --avg 10: png {a.shape}, palette index equal in "
          f"{same * 100:.3f} % of pixels, max step "
          f"{int(np.abs(a - b).max()) if same else -1}", flush=True)
    if not (same >= 0.999 and np.abs(a - b).max() <= 1):
        raise AssertionError("cli waterfall disagrees with the CPU")
    fs = 30_720_000
    caps = {}
    for name, frames in (("wide", CLI_WIDE_FRAMES), ("mid", CLI_MID_FRAMES)):
        # the reader drops the first two 512-sample frames
        caps[name] = os.path.join(tmp, f"{name}.wav")
        t0 = time.perf_counter()
        wav.write_kiwi_iq_wav(caps[name], _wide_capture(
            2560 * frames + 1024, fs, 2560, device), fs)
        print(f"cli capture {name}: {2560 * frames + 1024} samples at "
              f"30.72 MHz written in {time.perf_counter() - t0:.2f} s",
              flush=True)
    top = str(len(CLI_CARRIERS))
    for prof in ("fast", "quality"):
        dirs = {k: os.path.join(tmp, f"wide_{prof}_{k}")
                for k in ("kernel", "plain")}
        argv = ["wideband", caps["wide"], "--n-chan", 2560, "--top", top,
                "--profile", prof]
        _reset_counts()
        with _CliClock() as clk:
            t0 = time.perf_counter()
            _cli([*argv, "-o", dirs["kernel"]])
            wall = time.perf_counter() - t0
        launches = _counts()
        secs = clk.cfg.chunk_in * clk.chunks / clk.cfg.fs_in
        print(f"cli wideband {prof} 2560 ch, {secs:.3f} s of capture: tier "
              f"{clk.tier()}, {clk.chunks} chunk(s) of "
              f"{clk.cfg.chunk_per_chan} frames, launches {launches}; wall "
              f"{wall:.3f} s = read {clk.t['read']:.3f} + process "
              f"{clk.t['process']:.4f} + writes {clk.t['write']:.3f} + copy "
              f"back and ranking {wall - sum(clk.t.values()):.3f}; "
              f"{wall / secs:.3f} s wall and {clk.t['process'] / secs:.4f} s "
              f"process a capture second", flush=True)
        if launches["channelize_fused"] < 1 or launches["chain_tail"] < 1:
            raise AssertionError(f"cli wideband {prof} missed a kernel")
        # the same call with the plain channelizer and tails on the card
        _reset_counts()
        with _PlainKernels():
            _cli([*argv, "-o", dirs["plain"]])
        if any(_counts().values()):
            raise AssertionError(f"cli wideband {prof} plain run launched "
                                 f"a kernel: {_counts()}")
        want = _carrier_names(clk.cfg)
        names = _check_names(f"cli wideband {prof}", dirs["kernel"], want)
        _check_names(f"cli wideband {prof} plain", dirs["plain"], want)
        snr = min(_wav_snr(os.path.join(dirs["plain"], f),
                           os.path.join(dirs["kernel"], f)) for f in names)
        print(f"cli wideband {prof}: the carriers' {len(names)} channels, "
              f"kernels vs plain on the card min {snr:.2f} dB (tol "
              f"{TOL_WAV_DB[prof]} dB)", flush=True)
        if not snr >= TOL_WAV_DB[prof]:
            raise AssertionError(f"cli wideband {prof} disagrees with its "
                                 f"plain kernels")
        out[f"cli_{prof}"] = {"launches": launches}
    for prof in ("fast", "quality"):
        dirs = {}
        for key, extra in (("card", []), ("cpu", ["--device", "cpu"])):
            dirs[key] = os.path.join(tmp, f"mid_{prof}_{key}")
            with _CliClock() as clk:
                _cli(["wideband", caps["mid"], "-o", dirs[key], "--n-chan",
                      2560, "--top", top, "--profile", prof, *extra])
        want = _carrier_names(clk.cfg)
        names = _check_names(f"cli wideband MID {prof}", dirs["card"], want)
        _check_names(f"cli wideband MID {prof} cpu", dirs["cpu"], want)
        snr = min(_wav_snr(os.path.join(dirs["cpu"], f),
                           os.path.join(dirs["card"], f)) for f in names)
        print(f"cli wideband MID {prof}: {len(names)} channels, card vs cpu "
              f"min {snr:.2f} dB (tol {TOL_WAV_DB[prof]} dB)", flush=True)
        if not snr >= TOL_WAV_DB[prof]:
            raise AssertionError(f"cli wideband MID {prof} disagrees with "
                                 f"the CPU")
    return out


def _pcts(xs) -> str:
    a = np.asarray(xs) * 1e3
    return (f"p50 {np.percentile(a, 50):.3f} ms, p99 "
            f"{np.percentile(a, 99):.3f} ms, max {a.max():.3f} ms")


def phase_session(device, tmp: str, n_frames: int = 240) -> dict:
    """`cli kiwi` against the port's fake KiwiSDR on localhost for
    n_frames frames of 512 IQ samples at 12 kHz and at 20.25 kHz (the
    rational resampler): the recorded WAV hears the served tone, and each
    `Receiver.process` of the session is timed; then `Receiver.process`
    (dispatch + fetch) and `DualChain.process` (MAIN + SUB) timed over
    SESSION_CHUNKS chunks each, against the real-time budget of a chunk."""
    from supersdr_tpu_torch.control import receiver as rxm
    from supersdr_tpu_torch.io import wav
    from supersdr_tpu_torch.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer
    from supersdr_tpu_torch.runtime import dualrx
    from supersdr_tpu_torch.apps import kiwi_session
    out = {}
    total = {k: 0 for k in _wrappers()}
    for fs in (12_000, 20_250):
        t = np.arange(512 * (n_frames + 8)) / fs
        iq = (0.2 * np.exp(2j * np.pi * 1000 * t)).astype(np.complex64)
        server = FakeKiwiServer(FakeKiwiConfig(
            iq_source=iq, n_frames=n_frames + 8, audio_rate=fs,
            audio_rate_true=float(fs))).start()
        lat, orig = [], rxm.Receiver.process

        def timed(self, blk, orig=orig, lat=lat):
            t0 = time.perf_counter()
            a = orig(self, blk)
            lat.append(time.perf_counter() - t0)
            return a
        wav_out = os.path.join(tmp, f"live_{fs}.wav")
        rxm.Receiver.process = timed
        _reset_counts()
        try:
            _cli(["kiwi", "-s", "127.0.0.1", "-p", server.port, "-f",
                  "14200", "--mode", "USB", "-o", wav_out, "--frames",
                  n_frames, "-b", "4"])
        finally:
            rxm.Receiver.process = orig
            server.stop()
        for k, v in _counts().items():
            total[k] += v
        data, rate = wav.read_audio_wav(wav_out)
        a = data.astype(np.float64)[len(data) // 2:] / 32767.0
        spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
        peak = np.argmax(spec) * rate / a.size
        cfg = kiwi_session._session_chain_cfg("USB", fs, 2048)
        budget = cfg.chunk / fs
        print(f"session cli kiwi {fs} Hz: {n_frames} frames, "
              f"{len(lat)} chunks of {cfg.chunk}, audio {data.shape} at "
              f"{rate} Hz peaking at {peak:.1f} Hz; Receiver.process "
              f"{_pcts(lat)} against the {budget * 1e3:.1f} ms budget",
              flush=True)
        if rate != 48_000 or len(lat) < n_frames * 512 // cfg.chunk - 2 \
                or abs(peak - 1000.0) > 5.0:
            raise AssertionError(f"session at {fs} Hz failed")
        # the receiver alone, and MAIN + SUB, over SESSION_CHUNKS chunks
        rng = np.random.default_rng(fs)
        blk = (0.05 * np.exp(2j * np.pi * 1000 * np.arange(cfg.chunk) / fs)
               + 0.002 * (rng.normal(size=cfg.chunk) + 1j * rng.normal(
                   size=cfg.chunk))).astype(np.complex64)
        rx = rxm.Receiver(cfg=cfg, center_freq_khz=14200.0, freq=14200.0,
                          radio_mode="USB")
        sub = rxm.Receiver(cfg=cfg, center_freq_khz=14200.0, freq=14201.0,
                           radio_mode="CW")
        dual = dualrx.DualChain(cfg)
        dual.refresh([rx, sub], [True, True])
        if {rx.device.type, dual.device.type} != {device.type}:
            raise AssertionError("the receivers are not on the card")
        times = {"rx": [], "rx_dispatch": [], "dual": []}
        for i in range(SESSION_CHUNKS + 8):
            t0 = time.perf_counter()
            o = rx.process_dispatch(blk)
            t1 = time.perf_counter()
            audio = rx.process_fetch(o)
            t2 = time.perf_counter()
            da, dr = dual.process(blk)
            t3 = time.perf_counter()
            if i >= 8:
                times["rx"].append(t2 - t0)
                times["rx_dispatch"].append(t1 - t0)
                times["dual"].append(t3 - t2)
        if not (np.isfinite(audio).all() and np.isfinite(da).all()
                and audio.shape == (cfg.audio_chunk,)
                and da.shape == (2, cfg.audio_chunk)):
            raise AssertionError("receiver outputs are not finite")
        for key, label in (("rx", "Receiver.process (dispatch + fetch)"),
                           ("rx_dispatch", "Receiver.process_dispatch"),
                           ("dual", "DualChain.process (MAIN + SUB)")):
            print(f"latency {fs} Hz {label}, {SESSION_CHUNKS} chunks of "
                  f"{cfg.chunk}: {_pcts(times[key])} against the "
                  f"{budget * 1e3:.1f} ms budget", flush=True)
        if fs == 12_000:
            device_share("Receiver.process 12 kHz", lambda: rx.process(blk),
                         calls=20, rows=6)
            device_share("DualChain.process 12 kHz",
                         lambda: dual.process(blk), calls=20, rows=6)
        out[f"latency_{fs}"] = {k: (float(np.percentile(v, 50)) * 1e3,
                                    float(np.percentile(v, 99)) * 1e3)
                                for k, v in times.items()}
    out["launches"] = total
    return out


MONITOR_CHUNKS = 3
MONITOR_THRESH_DB = -70.0        # carriers ~-40 dB, the floor at -127
LIVE_FRAMES = 240
LIVE_KEYS = [[], ["y"], [], ["n"], ["a"], [], ["RIGHT"], [], ["Y"]]
TOL_RSSI_DB = 0.05               # planar fast: the in-kernel power row


def _carrier_freqs(cfg) -> list:
    """CLI_CARRIERS' channel centres in Hz (sorted), by PFB bin."""
    from supersdr_tpu_torch.ops import channelizer
    from supersdr_tpu_torch.runtime import wideband as wb
    centres = channelizer.channel_center_freqs(wb.pfb_plan(cfg), cfg.fs_in)
    return sorted(float(centres[ch]) for ch, _ in CLI_CARRIERS)


# one row of the monitor's activity table: mark, row, frequency, RSSI
_MON_ROW = re.compile(r"^[ >] +(\d+) +([+-]\d+\.\dk) +([+-]\d+\.\d)")


class _HostClock:
    """Wall time of MonitorCore._host, the only host crossings of `push`,
    each after the card has finished (so the copy's time, not the wait)."""

    def __enter__(self):
        from supersdr_tpu_torch.apps import monitor
        self.cls, self.s = monitor.MonitorCore, 0.0
        self.saved = self.cls.__dict__["_host"]
        orig = self.saved.__func__

        def timed(t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(t)
            self.s += time.perf_counter() - t0
            return out
        self.cls._host = staticmethod(timed)
        return self

    def __exit__(self, *exc):
        self.cls._host = self.saved


def _monitor_run(cfg, chunks, device, wav_path, process_fn=None,
                 params=None):
    """MonitorCore over `chunks` with the CLI_CARRIERS[1] channel
    selected and recorded; returns (core, launches, push seconds)."""
    from supersdr_tpu_torch.apps.monitor import MonitorCore
    core = MonitorCore(cfg, params=params, process_fn=process_fn,
                       thresh_db=MONITOR_THRESH_DB, device=device)
    core.select_freq(_carrier_freqs(cfg)[1])
    core.start_recording(wav_path)
    _reset_counts()
    secs = []
    for c in chunks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core.push(c)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = _counts()
    core.stop_recording()
    return core, launches, secs


def _same_activity(label, got, want, rssi_tol) -> None:
    ga, wa = got.activity(), want.activity()
    rows_ok = [(r, f) for r, f, _ in ga] == [(r, f) for r, f, _ in wa]
    d = float(np.abs(got.rssi_rows - want.rssi_rows).max())
    print(f"{label}: activity {len(ga)} channels {'equal' if rows_ok else 'DIFFER'}"
          f", rssi_rows max |diff| {d:.4f} dB (tol {rssi_tol} dB)",
          flush=True)
    if not rows_ok or not d <= rssi_tol:
        raise AssertionError(f"{label} disagrees")


def _monitor_replays_traced(core, chunks, tmp: str) -> None:
    """The wire chunks of a `MonitorCore` replay its held graph, whose
    launches the wrappers count from its recording: a profiler trace of
    the replays must hold each counted kernel once a chunk, as counted."""
    from supersdr_tpu_torch.runtime import stream_graph as sg
    from supersdr_tpu_torch.utils import profiling
    if not isinstance(core.process_fn, sg.GraphRunner):
        raise AssertionError("the monitor's wire chunks are not graphed")
    logdir = os.path.join(tmp, "mon_i16_trace")
    before = _counts()
    with profiling.trace(logdir):
        # a tracer that ran before in the process records the first
        # replay of a session in part (`phase_graph`): one replay first,
        # then a marker kernel, then the counted ones
        core.push(chunks[0])
        torch.cuda._sleep(0)
        for c in chunks:
            core.push(c)
    kernels = _trace_kernels(profiling.trace_files(logdir)[-1],
                             after=profiling.MARKER_KERNEL)
    ran = {w: sum(v for k, v in kernels.items() if name in k)
           for w, name in (("channelize_fused", "channelize_mma_kernel"),
                           ("chain_tail", "chain_tail_fir_kernel"))}
    counted = _grew(before)
    n = len(chunks)
    print(f"monitor i16 replays traced: {n} chunks after one and a marker "
          f"ran {ran}; counted {counted} over {n + 1}", flush=True)
    if ran != {w: n for w in ran} or counted != {w: n + 1 for w in ran}:
        raise AssertionError("the monitor's replays ran other launches "
                             "than they counted")


def phase_monitor(device, tmp: str) -> dict:
    """The wideband monitor at full width: `MonitorCore` over the HEADLINE
    fast config (planar, 2560 channels, 16128 frames a chunk) on
    MONITOR_CHUNKS chunks of CLI_CARRIERS' capture held on the card, fed
    as complex64 and as int16 wire pairs, each against the same run with
    the plain kernels on the card (activity rows and frequencies, RSSI
    table, the selected channel's recording); the int16 core's graph
    replays traced, each counted kernel once a chunk as counted;
    `MonitorCore` over `sharded_wideband.build` on 8 shards; ms a chunk of `push` and of its
    host copies; then `cli monitor --n-chan 2560 --headless` on the CLI's
    30.72 MHz WAV, the card against --device cpu."""
    from supersdr_tpu_torch.parallel import sharded_wideband as sw
    from supersdr_tpu_torch.runtime import wideband as wb
    cfg = wb.WidebandConfig(**HEADLINE, **wb.PROFILES["fast"])
    if not wb._planar_active(cfg):
        raise AssertionError("the monitor's HEADLINE config is not planar")
    n = cfg.chunk_in
    z = _wide_capture_dev(n * MONITOR_CHUNKS, cfg.fs_in, cfg.n_chan, device)
    f32 = [z[i * n:(i + 1) * n] for i in range(MONITOR_CHUNKS)]
    q = torch.view_as_real(z) * 32768.0
    q = q.round().clamp(-32768, 32767).to(torch.int16)
    i16 = [(q[i * n:(i + 1) * n, 0].contiguous(),
            q[i * n:(i + 1) * n, 1].contiguous())
           for i in range(MONITOR_CHUNKS)]
    del z, q
    want = _carrier_freqs(cfg)
    out, cores = {}, {}
    for kind, chunks in (("f32", f32), ("i16", i16)):
        path = "monitor" if kind == "f32" else "monitor_i16"
        core, launches, secs = _monitor_run(
            cfg, chunks, device, os.path.join(tmp, f"mon_{kind}.wav"))
        got = sorted(f for _, f, _ in core.activity())
        print(f"monitor {kind} HEADLINE fast: {MONITOR_CHUNKS} chunks, "
              f"launches {launches}, activity at {[round(f) for f in got]}"
              f" Hz; push {', '.join(f'{s * 1e3:.2f}' for s in secs)} ms",
              flush=True)
        if got != want or launches["channelize_fused"] != MONITOR_CHUNKS \
                or launches["chain_tail"] != MONITOR_CHUNKS:
            raise AssertionError(f"monitor {kind} missed its carriers or "
                                 f"its kernels")
        with _PlainKernels():
            plain, pl, _ = _monitor_run(
                cfg, chunks, device, os.path.join(tmp, f"mon_{kind}_p.wav"))
        if any(pl.values()):
            raise AssertionError(f"monitor plain run launched {pl}")
        _same_activity(f"monitor {kind} kernels vs plain", core, plain,
                       TOL_RSSI_DB)
        snr = _wav_snr(os.path.join(tmp, f"mon_{kind}_p.wav"),
                       os.path.join(tmp, f"mon_{kind}.wav"))
        print(f"monitor {kind}: selected channel "
              f"{core.freqs[core.selected]:+.0f} Hz recorded, kernels vs "
              f"plain {snr:.2f} dB (tol {TOL_WAV_DB['fast']} dB)", flush=True)
        if not snr >= TOL_WAV_DB["fast"]:
            raise AssertionError(f"monitor {kind} recording disagrees")
        out[path] = {"launches": launches}
        cores[kind] = core
        del plain
        torch.cuda.empty_cache()
    _monitor_replays_traced(cores["i16"], i16, tmp)
    # the sharded pipeline's process fn, unmodified
    proc = sw.build(cfg, sw.make_mesh(MESH_D, device))
    params = cores["f32"].params

    def process_fn(p, st, iq):
        return proc(p, st, iq)
    process_fn.channel_order = proc.channel_order
    mesh, launches, secs = _monitor_run(cfg, f32, device,
                                        os.path.join(tmp, "mon_mesh.wav"),
                                        process_fn=process_fn, params=params)
    got = sorted(f for _, f, _ in mesh.activity())
    print(f"monitor mesh {MESH_D} shards ({proc.tier}, factors "
          f"{proc.planar_factors}): launches {launches}, activity at "
          f"{[round(f) for f in got]} Hz; push "
          f"{', '.join(f'{s * 1e3:.2f}' for s in secs)} ms", flush=True)
    if got != want or launches["halo"] != MONITOR_CHUNKS \
            or launches["channelize_fused"] != MONITOR_CHUNKS:
        raise AssertionError("the monitor over the mesh missed its carriers")
    out["monitor_mesh"] = {"launches": launches}
    del mesh, cores
    torch.cuda.empty_cache()
    # push, and of it the host copies, over chunks after two warm-up ones
    from supersdr_tpu_torch.apps.monitor import MonitorCore
    core = MonitorCore(cfg, thresh_db=MONITOR_THRESH_DB, device=device)
    core.start_recording(os.path.join(tmp, "mon_t.wav"))
    core.push(f32[0])
    core.push(f32[1])
    secs, host = [], []
    for i in range(6):
        with _HostClock() as hc:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            core.push(f32[i % MONITOR_CHUNKS])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        host.append(hc.s)
    core.stop_recording()
    print(f"time monitor push HEADLINE fast (recording one channel): "
          f"{_pcts(secs)}; of it the host copies (RSSI row means "
          f"{cfg.n_chan} floats, the selected row "
          f"{cfg.chunk_per_chan * 4} floats) {_pcts(host)}", flush=True)
    out["push_ms"] = (float(np.median(secs)) * 1e3,
                      float(np.median(host)) * 1e3)
    del core, f32, i16
    torch.cuda.empty_cache()
    # the CLI at the reference's defaults: chan-major, no kernel; on the
    # WAV phase_cli wrote
    wide = os.path.join(tmp, "wide.wav")
    if not os.path.exists(wide):
        from supersdr_tpu_torch.io import wav
        wav.write_kiwi_iq_wav(wide, _wide_capture(
            cfg.n_chan * CLI_WIDE_FRAMES + 1024, cfg.fs_in, cfg.n_chan,
            device), cfg.fs_in)
    sel_khz = _carrier_freqs(cfg)[1] / 1e3
    text, recs = {}, {}
    for key, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        recs[key] = os.path.join(tmp, f"mon_cli_{key}.wav")
        buf = io.StringIO()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            _cli(["monitor", wide, "--n-chan", cfg.n_chan, "--headless",
                  "--thresh", MONITOR_THRESH_DB, "--select", sel_khz,
                  "--record", recs[key], "--print-every", 1, *extra])
        wall = time.perf_counter() - t0
        text[key] = [ln for ln in buf.getvalue().splitlines()
                     if _MON_ROW.match(ln)]
        print(f"cli monitor --n-chan {cfg.n_chan} {key}: {wall:.2f} s wall, "
              f"launches {_counts()}, {len(text[key])} activity lines",
              flush=True)
    same = text["card"] == text["cpu"]
    rows = [_MON_ROW.match(ln).group(1, 2) for ln in text["card"]] == \
        [_MON_ROW.match(ln).group(1, 2) for ln in text["cpu"]]
    snr = _wav_snr(recs["cpu"], recs["card"])
    print(f"cli monitor: activity lines {'identical' if same else 'differ'}"
          f" (rows and frequencies {'equal' if rows else 'DIFFER'}), "
          f"recording card vs cpu {snr:.2f} dB (tol {TOL_WAV_DB[None]} dB)",
          flush=True)
    if not (rows and len(text["card"]) >= 6 and snr >= TOL_WAV_DB[None]):
        raise AssertionError("cli monitor disagrees with the CPU")
    return out


class _Tty:
    """A terminal on stdin, so `kiwi --tui` takes its keys from
    `live_tui.stdin_keys` (a key script here)."""

    def isatty(self):
        return True


def _kiwi_tui(tmp: str, key: str, extra: list) -> tuple:
    """`cli kiwi --tui` against the fake KiwiSDR on localhost with
    LIVE_KEYS; returns (the recorded WAV's path, frames rendered)."""
    from supersdr_tpu_torch.apps import live_tui
    from supersdr_tpu_torch.io.fake_kiwi import FakeKiwiConfig, FakeKiwiServer
    fs = 12_000
    t = np.arange(512 * (LIVE_FRAMES + 8)) / fs
    iq = (0.2 * np.exp(2j * np.pi * 1000 * t)
          + 0.1 * np.exp(2j * np.pi * 2500 * t)).astype(np.complex64)
    server = FakeKiwiServer(FakeKiwiConfig(
        iq_source=iq, n_frames=LIVE_FRAMES + 8, audio_rate=fs,
        audio_rate_true=float(fs))).start()
    wav_out = os.path.join(tmp, f"tui_{key}.wav")
    frames, keys = [], iter(LIVE_KEYS)
    saved = (live_tui.ansi_render, live_tui.stdin_keys, sys.stdin)
    live_tui.ansi_render = frames.append
    live_tui.stdin_keys = lambda *a, **k: (lambda: next(keys, []))
    sys.stdin = _Tty()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _cli(["kiwi", "-s", "127.0.0.1", "-p", server.port, "-f",
                  "14200", "--mode", "USB", "-o", wav_out, "--frames",
                  LIVE_FRAMES, "--tui", *extra])
    finally:
        live_tui.ansi_render, live_tui.stdin_keys, sys.stdin = saved
        server.stop()
    return wav_out, frames


def phase_live(device, tmp: str) -> dict:
    """The live interactive session: `cli kiwi --tui` against the fake
    KiwiSDR with keys injected (SUB on, SUB to the centre, AM, a retune,
    SUB off), the card against --device cpu; `LiveTui.step` (MAIN + SUB
    and the native waterfall) timed over SESSION_CHUNKS chunks of 2048
    samples at 12 kHz against the chunk's budget; `run_tui_wav` on the
    off-air-style fixture, the card against the CPU."""
    from supersdr_tpu_torch.apps import live_tui, tui
    from supersdr_tpu_torch.control.panadapter import Panadapter
    from supersdr_tpu_torch.control.receiver import Receiver
    from supersdr_tpu_torch.io import wav
    from supersdr_tpu_torch.runtime import chain
    out = {}
    _reset_counts()
    card, frames = _kiwi_tui(tmp, "card", [])
    out["launches"] = _counts()
    cpu, _ = _kiwi_tui(tmp, "cpu", ["--device", "cpu"])
    a, ra = wav.read_audio_wav(card)
    b, rb = wav.read_audio_wav(cpu)
    subs = sum(f[1].startswith(" SUB") for f in frames)
    snr = _snr_db(torch.from_numpy(b.astype(np.float64)),
                  torch.from_numpy(a.astype(np.float64))) \
        if a.shape == b.shape else -1.0
    print(f"live cli kiwi --tui {LIVE_FRAMES} frames: audio {a.shape} at "
          f"{ra} Hz, {len(frames)} frames rendered ({subs} with the SUB "
          f"line), launches {out['launches']}; card vs cpu {snr:.2f} dB "
          f"(tol {TOL_WAV_DB[None]} dB)", flush=True)
    if not (ra == rb == 48_000 and a.shape == b.shape and subs
            and a.shape[0] >= LIVE_FRAMES * 512 * 4 - 4 * 2048
            and snr >= TOL_WAV_DB[None]):
        raise AssertionError("live kiwi --tui disagrees with the CPU")
    # LiveTui.step with SUB on
    fs = 12_000
    cfg = chain.ChainConfig(mode="USB", iq_rate=fs, audio_rate=48_000,
                            chunk=2048, os_block=2048)
    rx = Receiver(cfg=cfg, center_freq_khz=14200.0, freq=14200.0,
                  radio_mode="USB")
    s = live_tui.LiveTui.create(rx, Panadapter(zoom=10, freq_khz=14200.0),
                                width=100, wf_height=18)
    s.pan.set_freq_zoom(14202.0, s.pan.zoom)
    s.handle_key("y")
    if {rx.device.type, s.rx_sub.device.type, s._win.device.type} \
            != {device.type}:
        raise AssertionError("the live session is not on the card")
    rng = np.random.default_rng(23)
    n = 2048
    blk = (0.05 * np.exp(2j * np.pi * 1000 * np.arange(n) / fs)
           + 0.002 * (rng.normal(size=n) + 1j * rng.normal(size=n))
           ).astype(np.complex64)
    times, dual = [], []
    orig = s._dual_process

    def timed_dual(iq, orig=orig):
        t0 = time.perf_counter()
        r = orig(iq)
        dual.append(time.perf_counter() - t0)
        return r
    s._dual_process = timed_dual
    for i in range(SESSION_CHUNKS + 8):
        t0 = time.perf_counter()
        o = s.step(blk)
        times.append(time.perf_counter() - t0)
    times, dual = times[8:], dual[8:]
    budget = n / fs
    print(f"latency LiveTui.step 12 kHz MAIN + SUB + waterfall, "
          f"{SESSION_CHUNKS} chunks of {n}: {_pcts(times)}; of it "
          f"DualChain {_pcts(dual)}; against the {budget * 1e3:.1f} ms "
          f"budget", flush=True)
    if not (np.isfinite(o).all() and o.shape == (4 * n, 2)
            and len(s.model.history) == 18):
        raise AssertionError("LiveTui.step outputs are wrong")
    out["step_ms"] = (float(np.percentile(times, 50)) * 1e3,
                      float(np.percentile(times, 99)) * 1e3)
    s._dual_process = orig
    device_share("LiveTui.step 12 kHz", lambda: s.step(blk), calls=20,
                 rows=6)
    # run_tui_wav, card against CPU
    fixture = "tests/fixtures/kiwi_am_offair_12k.wav"
    hist = {}
    for key, dev in (("card", None), ("cpu", "cpu")):
        with contextlib.redirect_stdout(io.StringIO()):
            m = tui.run_tui_wav(fixture, mode="AM", width=96, height=40,
                                speed=1e9, device=dev)
        hist[key] = np.stack(m.history).astype(np.uint8).astype(int)
    a, b = hist["card"], hist["cpu"]
    same = float(np.mean(a == b)) if a.shape == b.shape else 0.0
    print(f"live run_tui_wav fixture: history {a.shape}, palette index "
          f"equal in {same * 100:.3f} % of cells, max step "
          f"{int(np.abs(a - b).max()) if same else -1}", flush=True)
    if not (same >= 0.999 and np.abs(a - b).max() <= 1):
        raise AssertionError("run_tui_wav disagrees with the CPU")
    return out


GRAPH_CHUNKS = 64
GRAPH_RING = 8


def _graph_ring(cfg, device) -> list:
    """GRAPH_RING wire chunks (int16 pairs in pinned host memory) of the
    CLI's carriers at cfg's shape."""
    n = cfg.chunk_in
    z = _wide_capture_dev(n * GRAPH_RING, cfg.fs_in, cfg.n_chan, device)
    q = (torch.view_as_real(z) * 32768.0).round().clamp(-32768, 32767)
    q = q.to(torch.int16).cpu()
    return [tuple(q[i * n:(i + 1) * n, j].contiguous().pin_memory()
                  for j in range(2)) for i in range(GRAPH_RING)]


def _grew(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def phase_graph(device, tmp: str) -> dict:
    """The live monitor's held graph (`runtime/stream_graph.py`) at the
    live shape (MID: 2560 channels, 512 frames a chunk) on both tiers:
    GRAPH_CHUNKS wire chunks from pinned memory through a default
    `MonitorCore`'s graphed process function and through its eager one,
    every chunk's audio and RSSI and the final state equal bit for bit; a
    fresh `init_state` handed in is copied in; an in-place `copy_` into
    an AGC parameter and a new parameters object are read by the next
    chunk (each changes its audio, and the graph is recorded anew); each
    counted wrapper grows by exactly one a replay (the channelizer's and
    the FIR tail's); a profiler trace of 8 replays holds
    `channelize_mma_kernel` and `chain_tail_fir_kernel` once a chunk;
    push + fetch p50 ms of a graphed and an eager `MonitorCore`."""
    from supersdr_tpu_torch.apps.monitor import MonitorCore
    from supersdr_tpu_torch.runtime import stream_graph as sg
    from supersdr_tpu_torch.runtime import wideband as wb
    from supersdr_tpu_torch.utils import held, profiling
    total = {k: 0 for k in _wrappers()}
    one = {"channelize_fused": 1, "chain_tail": 1}
    out = {}
    for tier in ("fast", "quality"):
        cfg = wb.WidebandConfig(**MID, **wb.PROFILES[tier])
        ring = _graph_ring(cfg, device)
        core = MonitorCore(cfg, device=device)
        runner = core.process_fn
        if not isinstance(runner, sg.GraphRunner):
            raise AssertionError(f"graph {tier}: the monitor is not graphed")
        eager, params = runner.eager, core.params
        st_g = st_e = core.state
        recorded = []
        for i in range(GRAPH_CHUNKS):
            c = ring[i % GRAPH_RING]
            if i == GRAPH_CHUNKS // 4:        # a foreign state
                st_g = wb.init_state(cfg, device=device)
                st_e = wb.init_state(cfg, device=device)
            if i in (GRAPH_CHUNKS // 2, 3 * GRAPH_CHUNKS // 4):
                old = params
                if i == GRAPH_CHUNKS // 2:    # written in place
                    old = sg._clone(params)
                    params.chain.agc.target_db.copy_(
                        params.chain.agc.target_db - 6.0)
                else:                         # a new object
                    agc = params.chain.agc._replace(
                        target_db=params.chain.agc.target_db + 3.0)
                    params = params._replace(
                        chain=params.chain._replace(agc=agc))
                _, stale, _ = eager(old, sg._clone(st_e), c)
            st_e, a_e, r_e = eager(params, st_e, c)
            before = _counts()
            st_g, a_g, r_g = runner(params, st_g, c)
            grew = _grew(before)
            if i in (GRAPH_CHUNKS // 2, 3 * GRAPH_CHUNKS // 4):
                # recorded anew: the recording's eager run, then the replay
                recorded.append(grew)
                if grew != {k: 2 * v for k, v in one.items()}:
                    raise AssertionError(f"graph {tier}: chunk {i} "
                                         f"launched {grew} recording anew")
                if torch.equal(stale, a_e):
                    raise AssertionError(f"graph {tier}: the parameters' "
                                         f"change at chunk {i} moved "
                                         f"nothing")
            elif grew != one:
                raise AssertionError(f"graph {tier}: chunk {i} launched "
                                     f"{grew}, a replay launches {one}")
            if st_g is not runner.state or not (
                    torch.equal(a_g, a_e) and torch.equal(r_g, r_e)):
                raise AssertionError(f"graph {tier}: chunk {i} differs "
                                     f"from the eager chunk")
        same = all(torch.equal(a, b) for a, b in
                   zip(held.leaves(st_g), held.leaves(st_e), strict=True))
        if not same:
            raise AssertionError(f"graph {tier}: the final state differs")
        # a profiler trace of 8 replays
        logdir = os.path.join(tmp, f"graph_{tier}")
        profiling.clear_spans()
        with profiling.trace(logdir):
            # a tracer that ran before in the process records the first
            # replay of a session in part (its nodes before the FIR tail):
            # one replay first, then a marker kernel, then the 8 counted
            with profiling.span("monitor.push"):
                st_g, _, _ = runner(params, st_g, ring[0])
            torch.cuda._sleep(0)
            for i in range(8):
                with profiling.span("monitor.push"):
                    st_g, _, _ = runner(params, st_g, ring[i])
        replays = sum(profiling.graphs().values())
        profiling.clear_spans()
        kernels = _trace_kernels(profiling.trace_files(logdir)[-1],
                                 after=profiling.MARKER_KERNEL)
        chan = sum(v for k, v in kernels.items()
                   if "channelize_mma_kernel" in k)
        tail = sum(v for k, v in kernels.items()
                   if "chain_tail_fir_kernel" in k)
        print(f"graph {tier} MID: {GRAPH_CHUNKS} chunks graphed and eager "
              f"equal bit for bit (audio, RSSI, final state; a foreign "
              f"state at {GRAPH_CHUNKS // 4}, AGC target written in place "
              f"at {GRAPH_CHUNKS // 2}, new parameters at "
              f"{3 * GRAPH_CHUNKS // 4}: launches {recorded}); a replay "
              f"launches {one}; 8 traced replays after one and a marker "
              f"({replays} of 9 held): channelize_mma_kernel {chan}, "
              f"chain_tail_fir_kernel {tail}", flush=True)
        if (chan, tail, replays) != (8, 8, 9):
            raise AssertionError(f"graph {tier}: the trace of 8 replays "
                                 f"holds {chan} / {tail} kernels: "
                                 f"{kernels}")
        # push + fetch, graphed against eager, from pinned memory
        core.params = params
        eager_core = MonitorCore(cfg, params=params, process_fn=eager,
                                 device=device)
        ms = {}
        before = _counts()
        for name, mc in (("graphed", core), ("eager", eager_core)):
            for c in ring[:4]:
                mc.push(c)
                mc.selected_audio()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            secs = []
            for i in range(GRAPH_CHUNKS):
                t0 = time.perf_counter()
                mc.push(ring[i % GRAPH_RING])
                mc.selected_audio()
                secs.append(time.perf_counter() - t0)
            ms[name] = (float(np.percentile(secs, 50)) * 1e3,
                        float(np.percentile(secs, 95)) * 1e3,
                        torch.cuda.max_memory_allocated() / 2**30,
                        torch.cuda.memory_reserved() / 2**30)
        for k, v in _grew(before).items():
            total[k] += v
        print(f"graph {tier} MID push + fetch ms p50 / p95, peak allocated "
              f"/ reserved GiB over {GRAPH_CHUNKS} chunks: " + "; ".join(
                  f"{k} {v[0]:.4f} / {v[1]:.4f}, {v[2]:.4f} / {v[3]:.4f}"
                  for k, v in ms.items()), flush=True)
        out[tier] = ms
        del core, eager_core, runner, ring
        torch.cuda.empty_cache()
    return {"launches": total, "ms": out}


def phase_checkpoint(device, tmp: str, seed: int = 24) -> dict:
    """Stream checkpoint/resume on the card: HEADLINE fast planar, 4 chunks
    straight against 2 chunks, `save_state`, `load_state` into a fresh
    `init_state`, 2 more: audio and RSSI bit-identical; the same for one
    receiver's `runtime/chain` (USB, 12 kHz, 2048 samples a chunk)."""
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.runtime import chain
    from supersdr_tpu_torch.runtime import checkpoint as ckpt
    from supersdr_tpu_torch.runtime import wideband as wb
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = wb.WidebandConfig(**HEADLINE, **wb.PROFILES["fast"])
    params = wb.make_params(cfg, device=device)
    n = cfg.chunk_in
    chunks = [cx.CX(*(torch.randn(n, generator=gen, device=device) * 0.05
                      for _ in range(2))) for _ in range(4)]

    def run(st, cs):
        outs = []
        for c in cs:
            st, o = wb.process(cfg, params, st, c)
            outs.append((o.audio, o.rssi))
        return st, outs
    _reset_counts()
    _, straight = run(wb.init_state(cfg, device=device), chunks)
    st, first = run(wb.init_state(cfg, device=device), chunks[:2])
    path = os.path.join(tmp, "wb_state.npz")
    t0 = time.perf_counter()
    ckpt.save_state(path, st, meta={"chunks": 2})
    t1 = time.perf_counter()
    st2 = ckpt.load_state(path, wb.init_state(cfg, device=device))
    t2 = time.perf_counter()
    _, rest = run(st2, chunks[2:])
    _sync(device)
    launches = _counts()
    same = [bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
            for a, b in zip(straight, first + rest)]
    leaves = ckpt.checkpoint_meta(path)["n_leaves"]
    print(f"checkpoint wideband HEADLINE fast: {leaves} leaves, "
          f"{os.path.getsize(path) / 1e6:.1f} MB, save {t1 - t0:.3f} s, "
          f"load {t2 - t1:.3f} s, on {st2.chain.agc.gain_db.device}; "
          f"launches {launches}; resumed chunks bit-identical {same}",
          flush=True)
    if not all(same) or launches["channelize_fused"] != 8 \
            or launches["chain_tail"] != 8 \
            or st2.chain.agc.gain_db.device != params.W_pfb.device:
        raise AssertionError("the resumed wideband stream differs")
    del straight, first, rest, chunks
    torch.cuda.empty_cache()
    ccfg = chain.ChainConfig(mode="USB", iq_rate=12_000, audio_rate=48_000,
                             chunk=2048, os_block=2048)
    cp = chain.make_params(ccfg, freq_offset_hz=300.0, device=device)
    iq = torch.complex(torch.randn(4 * 2048, generator=gen, device=device),
                       torch.randn(4 * 2048, generator=gen, device=device)
                       ) * 0.1
    cs = [iq[i * 2048:(i + 1) * 2048] for i in range(4)]

    def crun(st, cs):
        outs = []
        for c in cs:
            st, o = chain.process(ccfg, cp, st, c)
            outs.append((o.audio, o.rssi))
        return st, outs
    _, straight = crun(chain.init_state(ccfg, device=device), cs)
    st, first = crun(chain.init_state(ccfg, device=device), cs[:2])
    path = os.path.join(tmp, "chain_state.npz")
    ckpt.save_state(path, st)
    _, rest = crun(ckpt.load_state(path, chain.init_state(ccfg,
                                                          device=device)),
                   cs[2:])
    same = [bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
            for a, b in zip(straight, first + rest)]
    print(f"checkpoint chain one receiver: resumed chunks bit-identical "
          f"{same}", flush=True)
    if not all(same):
        raise AssertionError("the resumed chain stream differs")
    return {"launches": launches}


def _trace_kernels(path: str, after: str | None = None) -> dict:
    """Kernel events of a Chrome trace: name → count; with `after`, only
    those that start after the first kernel whose name holds it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    if after is not None:
        t0 = min(e["ts"] for e in events if after in e["name"])
        events = [e for e in events if e["ts"] > t0]
    names = {}
    for e in events:
        names[e["name"]] = names.get(e["name"], 0) + 1
    return names


BENCH_GATES = ("small", "mid", "midssb", "midnbfm")
# the gates whose rows are also held against the JAX package's fixture
BENCH_JAX_GATES = ("mid", "midssb", "midnbfm")


def phase_bench(device) -> dict:
    """`cli bench`'s measurement, both tiers at HEADLINE, in this process;
    fails on a gate under 50 dB, int16 at or under 80 dB against float32,
    an error entry, integrity not "pass", or a kernel that did not
    launch."""
    from supersdr_tpu_torch import bench
    _reset_counts()
    t0 = time.perf_counter()
    out = bench.results(device)
    seconds = time.perf_counter() - t0
    launches = _counts()
    print(json.dumps(out), flush=True)
    print(f"bench: {seconds:.1f} s, launches {launches}", flush=True)
    other = "quality" if out["profile"] == "fast" else "fast"
    tiers = {out["profile"]: out, other: out.get(other, {})}
    for name, tier in tiers.items():
        i16 = tier.get("i16_ingest", {})
        low = [g for g in BENCH_GATES
               if not tier.get(f"oracle_snr_db_{g}", 0.0) >= 50.0]
        low += [f"{g} (jax rows)" for g in BENCH_JAX_GATES
                if not tier.get(f"jax_snr_db_{g}", 0.0) >= 50.0]
        if "error" in tier or "error" in i16 \
                or tier.get("integrity") != "pass" \
                or not tier.get("value", 0.0) > 0 or low \
                or not i16.get("vs_f32_snr_db", 0.0) > 80.0:
            raise AssertionError(f"bench {name} failed (gates under 50 dB: "
                                 f"{low})")
    if not (launches["channelize_fused"] and launches["chain_tail"]):
        raise AssertionError(f"bench launched no kernel: {launches}")
    for tier in ("fast", "quality"):
        bench_loop_share(device, tier)
    return {"launches": launches, "out": out}


def bench_loop_share(device, tier: str, steps: int = 8) -> None:
    """The card's idle share in the bench's own timed loop: `steps` of its
    step back to back, one reduction of the last audio read at the end."""
    from supersdr_tpu_torch import bench
    from supersdr_tpu_torch.runtime import wideband as wb
    cfg = wb.WidebandConfig(**bench.HEADLINE, **wb.PROFILES[tier])
    params = wb.make_params(cfg, device=device)
    st = [wb.init_state(cfg, device=device)]
    step, _ = bench.timed_step(cfg, params, device)

    def loop():
        for _ in range(steps):
            st[0], audio = step(st[0])
        return float(audio.abs().mean())
    device_share(f"bench loop {tier} ({steps} steps of {bench.N_SCAN} "
                 f"chunks, one reduction)", loop, calls=2, rows=6)


def phase_trace(device, tmp: str, seed: int = 25) -> dict:
    """`utils.profiling.trace` around one `process_n` call (2 chunks) at
    HEADLINE fast: the written trace names the channelizer and the FIR
    tail kernels; the traced call's time beside an untraced one."""
    from supersdr_tpu_torch.runtime import wideband as wb
    from supersdr_tpu_torch.utils import profiling
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = wb.WidebandConfig(**HEADLINE, **wb.PROFILES["fast"])
    params = wb.make_params(cfg, device=device)
    f32, _ = _headline_inputs(cfg, gen, device)

    def call():
        wb.process_n(cfg, params, wb.init_state(cfg, device=device), f32)
        torch.cuda.synchronize()
    call()
    plain = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        plain.append(time.perf_counter() - t0)
    logdir = os.path.join(tmp, "trace")
    _reset_counts()
    t0 = time.perf_counter()
    with profiling.trace(logdir):
        t1 = time.perf_counter()
        call()
        traced = time.perf_counter() - t1
    whole = time.perf_counter() - t0
    launches = _counts()
    files = profiling.trace_files(logdir)
    kernels = _trace_kernels(files[-1]) if files else {}
    chan = sum(v for k, v in kernels.items() if "channelize_mma_kernel" in k)
    tail = sum(v for k, v in kernels.items() if "chain_tail_fir_kernel" in k)
    print(f"trace process_n HEADLINE fast (2 chunks): {len(files)} file(s), "
          f"{os.path.getsize(files[-1]) / 1e6 if files else 0:.2f} MB, "
          f"{sum(kernels.values())} kernel events of {len(kernels)} names, "
          f"channelize_mma_kernel {chan}, chain_tail_fir_kernel {tail}; "
          f"the call {traced * 1e3:.2f} ms traced ({whole * 1e3:.1f} ms "
          f"with the profiler's start and the trace's write) against "
          f"{' / '.join(f'{p * 1e3:.2f}' for p in plain)} ms untraced; "
          f"launches {launches}", flush=True)
    if len(files) != 1 or chan != 2 or tail != 2:
        raise AssertionError("the trace does not name the kernels")
    return {"launches": launches}


def fold_library(run: dict, iters: int = 5, seed: int = 15) -> float:
    """The fold as one library call at HEADLINE: `F.conv1d(groups=M)`
    (cuDNN) on the real and imaginary parts as one batch of two, the
    rows laid out channel-major outside the timing. Held against the
    plain fold; never called by the port."""
    import torch.nn.functional as F
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.ops.cuda import pfb_fold as pf
    from supersdr_tpu_torch.runtime import wideband as wb
    cfg, params, chunks = run["cfg"], run["params"], run["chunks"]
    dev = chunks[0].re.device
    plan = wb.pfb_plan(cfg)
    M, K, nf = cfg.n_chan, cfg.taps_per, cfg.chunk_per_chan
    gen = torch.Generator(device=dev).manual_seed(seed)
    carry = cx.CX(*(torch.randn(plan.history, generator=gen, device=dev)
                    * 0.05 for _ in range(2)))
    x = chunks[0]
    G = params.W_pfb.reshape(-1).flip(0).reshape(K, M).contiguous()
    rows = torch.stack([torch.cat([carry.re, x.re]),
                        torch.cat([carry.im, x.im])]).reshape(2, nf + K - 1,
                                                              M)
    inp = rows.transpose(1, 2).contiguous()            # [2, M, nf + K − 1]
    w = G.T.contiguous()[:, None, :]                   # [M, 1, K]
    lib = F.conv1d(inp, w, groups=M)                   # [2, M, nf]
    ref = pf.pfb_fold_plain(G, carry.re, carry.im, x.re, x.im)
    snr = _snr_db(torch.view_as_real(ref),
                  torch.stack([lib[0].T, lib[1].T], dim=-1))
    ms = cuda_ms(lambda: F.conv1d(inp, w, groups=M), iters)
    print(f"library pfb_fold: F.conv1d(groups={M}) on [2, {M}, {nf + K - 1}]"
          f" {ms:.3f} ms, against the plain fold {snr:.2f} dB (tol "
          f"{TOL_SNR_DB['fold']} dB)", flush=True)
    if not snr >= TOL_SNR_DB["fold"]:
        raise AssertionError("the conv1d fold disagrees with the plain fold")
    return ms


def kernel_bounds(halo_bound: tuple) -> dict:
    """Each kernel's bound at the shape it is timed at (HEADLINE: 2560
    channels × 16128 frames), as (ms, what bounds it).

    The channelizer ("channelize_fused", "channelize_fused_quality": int16
    input, which the cells feed) and the FIR tail ("chain_tail",
    "chain_tail_quality") are bounded as the cells bound them
    (`cell_bound`, on the fast and quality cells' configuration files). The
    rest no cell counts yet, so they keep this file's own formulas
    (`bound_ms`: the card's float32 and bf16 peaks): the mesh's shapes on
    8 shards ("…_mesh": (20, 128) with 24 planes, and the FIR tail on 3072
    rows), the fold kernel, the non-FIR tails and the halo kernel."""
    from supersdr_tpu_torch.parallel import sharded_wideband as sw
    from supersdr_tpu_torch.runtime import wideband as wb
    cfg = wb.WidebandConfig(**HEADLINE, **wb.PROFILES["fast"])
    ccfg = cfg.chain_cfg
    M, K, nf = cfg.n_chan, cfg.taps_per, cfg.chunk_per_chan
    per, L = ccfg.interp_plan.per, ccfg.upsample
    ov = cfg.n_taps - 1
    samples = nf * M

    def chan(n1, n2, n1_out, D):
        # f32 planes and D history heads in, bf16 raw planes out (phantom
        # planes included); fold and stage A in float32, stage B on bf16
        # operands
        return bound_ms(
            2 * 4 * (samples + D * (K - 1) * M) + 4 * K * M
            + 8 * n1 * n1 * n2 + 8 * n2 * n2 + 2 * 2 * nf * n1_out * n2,
            {"fp32": samples * (4 * K + 8 * n1), "bf16": samples * 8 * n2})

    def tail(C):
        # bf16 raw planes and f32 history in, f32 audio out; real taps on
        # bf16 operands, the rest in float32
        n = nf * C
        return bound_ms(
            2 * 2 * n + 2 * 4 * ov * C + (4 + per) * C * 4 * 2 + 4 * n * L,
            {"bf16": n * 4 * cfg.n_taps, "fp32": n * (2 * per * L + 40)})

    def am(C, n):
        # complex64 passband in, float32 audio out, the state rows in and
        # out; the resampler's and the scans' operations in float32
        return bound_ms(8 * n * C + (4 + per) * C * 4 * 2 + 4 * n * C * L,
                        {"fp32": n * C * (2 * per * L + 40)})
    m1, m2, m1_pad = sw.plan_mesh(cfg, MESH_D).factors
    fast, quality = cell_conf("hf2560_am_fast"), cell_conf("hf2560_am_quality")
    return {
        "channelize_fused": cell_bound("channelize_fused", fast, nf),
        "channelize_fused_quality": cell_bound("channelize_fused", quality,
                                               nf),
        "chain_tail": cell_bound("chain_tail_fir", fast, nf),
        "chain_tail_quality": cell_bound("chain_tail_fir", quality, nf),
        "channelize_fused_mesh": chan(m1, m2, m1_pad, MESH_D),
        "chain_tail_mesh": tail(m1_pad * m2),
        "pfb_fold": bound_ms(
            2 * 4 * (samples + (K - 1) * M) + 4 * K * M + 8 * samples,
            {"fp32": samples * 4 * K}),
        "chain_tail_am_c": am(M, nf),
        # the 33-tap time-major branch: two float32 planes in, time-major
        # audio and the power row out (the same bytes)
        "chain_tail_am": am(M, nf),
        # chain.process on 128 and 2560 receivers × its chunk of 2048
        "chain_tail_am_c_batch128": am(128, 2048),
        "chain_tail_am_c_batch2560": am(2560, 2048),
        "halo": halo_bound,
    }


def _summary(name: str, source: str, replaces: str, paths: dict, err: dict,
             times: tuple, bound: tuple, library_ms=None, **extra) -> dict:
    """One kernel's line: `launches` sums its launches over the main paths
    (each driven from a zeroed count), `paths` says where they were."""
    launches = {k: v["launches"].get(name, 0) for k, v in paths.items()}
    if sum(launches.values()) == 0:
        raise AssertionError(f"no main path launched {name}")
    return {"name": name, "route": "cuda",
            "source": f"supersdr_tpu_torch/csrc/{source}",
            "replaces": f"supersdr_tpu/ops/pallas/{replaces}",
            "launches": sum(launches.values()), "paths": launches,
            "max_abs_err": err[name], "ms": times[0], "plain_ms": times[1],
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from supersdr_tpu_torch import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = _nvidia_smi()
    print(f"card: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    _print_build(log, lib_path)
    # with no device given the port's constructors use the current card
    from supersdr_tpu_torch.runtime import wideband as wb
    small = wb.WidebandConfig(**dict(MID, fs_in=256 * 12_000, n_chan=256,
                                     chunk_in=256 * 64),
                              **wb.PROFILES["fast"])
    here = torch.device("cuda", torch.cuda.current_device())
    if wb.make_params(small).W_pfb.device != here \
            or wb.init_state(small).pfb_carry.re.device != here:
        raise AssertionError("the default device is not the current card")
    err: dict = {}
    phase_kernels(MID, dev, err)
    phase_halo(dev, err)
    main_path = phase_main_path(HEADLINE, dev)
    chan = phase_chanmajor(HEADLINE, dev)
    times = phase_timing(main_path["runs"], err)
    times.update(phase_chanmajor_timing(chan, err))
    times["pfb_fold_library"] = fold_library(chan)
    planar_ms = {p: times[f"main_{p}_f32"] for p in ("fast", "quality")}
    del main_path["runs"], chan["chunks"]
    torch.cuda.empty_cache()
    bench_run = phase_bench(dev)
    for tier in ("fast", "quality"):
        res = bench_run["out"] if tier == bench_run["out"]["profile"] \
            else bench_run["out"][tier]
        per_chunk = res["step_ms"] / bench_run["out"]["config"]["n_scan"]
        gap = per_chunk / times[f"main_{tier}_f32"] - 1.0
        print(f"bench {tier}: step_ms {res['step_ms']} ({per_chunk:.3f} ms "
              f"a chunk, host clock), main_{tier}_f32 "
              f"{times[f'main_{tier}_f32']:.3f} ms a chunk (CUDA events): "
              f"{100 * gap:+.1f} %", flush=True)
    torch.cuda.empty_cache()
    phase_rows(HEADLINE, dev)
    phase_rows(HEADLINE, dev, CHANMAJOR)
    controls = phase_controls(HEADLINE, dev)
    times.update(phase_squelch(dev, err))
    phase_chain(dev)
    with tempfile.TemporaryDirectory() as tmp:
        variants = phase_variants(dev, tmp)
    times.update(variants["times"])
    times.update(phase_am_batch(dev, err))
    times.update(phase_halo_timing(dev))
    sharded = phase_sharded(dev)
    with tempfile.TemporaryDirectory() as tmp:
        procs = phase_procs(dev, tmp)
    times.update(procs["times"])
    tmajor = phase_tmajor(dev, err, planar_ms)
    times.update(tmajor["times"])
    torch.cuda.empty_cache()
    mesh = phase_mesh(dev, err)
    times.update(mesh["times"])
    mesh_tiers = phase_mesh_tiers(dev)
    phase_mesh_parts(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cli_runs = phase_cli(dev, tmp)
        session = phase_session(dev, tmp)
        torch.cuda.empty_cache()
        monitor = phase_monitor(dev, tmp)
        graph = phase_graph(dev, tmp)
        live = phase_live(dev, tmp)
        checkpoint = phase_checkpoint(dev, tmp)
        torch.cuda.empty_cache()
        traced = phase_trace(dev, tmp)
    paths = {"planar": main_path, "chanmajor": chan, "sharded": sharded,
             "tmajor": tmajor, "mesh": mesh, "mesh_tiers": mesh_tiers,
             **cli_runs, "session": session, "monitor": monitor["monitor"],
             "monitor_i16": monitor["monitor_i16"],
             "monitor_mesh": monitor["monitor_mesh"], "graph": graph,
             "live": live,
             "checkpoint": checkpoint, "trace": traced, "bench": bench_run,
             "variants": variants, "controls_squelch": controls,
             **procs["paths"]}
    bounds = kernel_bounds(times["halo_bound"])
    kernels = [
        _summary("channelize_fused", "channelize_fused.cu",
                 "channelize_fused.py:61", paths, err,
                 times["channelize_fused_i16_fast"],
                 bounds["channelize_fused"],
                 f32_in_ms=times["channelize_fused_fast"][0],
                 quality_ms=times["channelize_fused_i16_quality"][0],
                 quality_plain_ms=times["channelize_fused_i16_quality"][1],
                 quality_bound_ms=bounds["channelize_fused_quality"][0],
                 mesh_ms=times["mesh_channelize_fused_fast"][0],
                 mesh_plain_ms=times["mesh_channelize_fused_fast"][1],
                 mesh_bound_ms=bounds["channelize_fused_mesh"][0]),
        _summary("chain_tail", "chain_tail.cu", "chain_tail.py:332", paths,
                 err, times["chain_tail_fast"], bounds["chain_tail"],
                 quality_ms=times["chain_tail_quality"][0],
                 quality_plain_ms=times["chain_tail_quality"][1],
                 quality_bound_ms=bounds["chain_tail_quality"][0],
                 mesh_ms=times["mesh_chain_tail_fast"][0],
                 mesh_plain_ms=times["mesh_chain_tail_fast"][1],
                 mesh_bound_ms=bounds["chain_tail_mesh"][0]),
        _summary("pfb_fold", "pfb_fold.cu", "pfb_fold.py:36", paths, err,
                 times["pfb_fold"], bounds["pfb_fold"],
                 library_ms=times["pfb_fold_library"]),
        _summary("chain_tail_am", "chain_tail.cu", "chain_tail.py:304",
                 paths, err, times["chain_tail_am_time"],
                 bounds["chain_tail_am"]),
        _summary("chain_tail_am_c", "chain_tail.cu", "chain_tail.py:304",
                 paths, err, times["chain_tail_am_c"],
                 bounds["chain_tail_am_c"],
                 **{f"{k}_{v}": x for k in ("batch128", "batch2560")
                    for v, x in (
                        ("ms", times[f"chain_tail_am_c_{k}"][0]),
                        ("plain_ms", times[f"chain_tail_am_c_{k}"][1]),
                        ("bound_ms", bounds[f"chain_tail_am_c_{k}"][0]))}),
        _summary("halo", "halo.cu", "halo.py:24", paths, err, times["halo"],
                 bounds["halo"], library_ms=times["halo_library"],
                 empty_launch_ms=times["halo_empty"],
                 call_ms=times["halo_call"],
                 **{f"{k}_us": dict(zip(("host", "card", "barrier",
                                         "kernel"), v))
                    for k, v in times.items() if k.startswith("halo_procs")}),
        {**_summary("squelch_gate", "squelch_gate.cu", "", paths, err,
                    times["squelch_gate"],
                    (times["squelch_gate_float32"][2], "bytes"),
                    **{f"{k}_{v}": times[f"squelch_gate_{k}"][i]
                       for k in ("float16", "bfloat16")
                       for i, v in enumerate(("ms", "plain_ms",
                                              "bound_ms"))}),
         "replaces": "none: supersdr_tpu/ops/squelch.py apply_squelch is "
                     "jnp code, no pallas_call"},
    ]
    print(f"procs (ms a SHARDED call / MESH chunk over the ranks against "
          f"one process; halo us a call from the host, on the card, the "
          f"bare handshake, the push launch alone): "
          f"{json.dumps(procs['times'])}", flush=True)
    for k in kernels:
        print(f"bound {k['name']}: {k['ms']:.4f} ms against "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}), launches "
              f"{k['paths']}", flush=True)
    for name, timed in (("channelize_fused", "channelize_fused_i16"),
                        ("chain_tail", "chain_tail")):
        q_ms, q_bound = (times[f"{timed}_quality"][0],
                         bounds[f"{name}_quality"])
        print(f"bound {name} quality: {q_ms:.4f} ms against "
              f"{q_bound[0]:.4f} ms ({q_bound[1]})", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
