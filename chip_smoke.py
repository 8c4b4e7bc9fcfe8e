"""Smoke test of the PyTorch port on one CUDA card (an H100, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. card identity (torch / CUDA versions, nvidia-smi name and power limit);
  2. build the five kernels from supersdr_tpu_torch/csrc with nvcc (one
     process a source, in parallel): the seconds each source took, every
     kernel variant's registers, stack and spills, and the tensor-core and
     asynchronous-copy instructions in the built library; and the port's
     default device (no `device` given: the current card);
  3. each kernel's wrapper against its plain PyTorch version on the card,
     at the MID shape (2560 channels, 512 frames a chunk): the channelizer
     on both tiers with float32 and int16 input (also at 2 × 256, 12 × 256
     and 5 × 512 channels, 40 frames), the FIR tail on AM, USB
     (complex taps) and NBFM on both tiers and with AGC hang, the fold, and
     the non-FIR tail on AM with hang off and on (500 and 40 ms), USB, NBFM
     (FM carriers, manual AGC), with the power row and on time-major
     planes; peak segments shorter than, as long as and longer than the
     tails' 256-sample scan piece; plus ragged last tiles (13 frames for
     the channelizer and the fold, 640 for both tails); the channelizer's
     time-major store (float32 and int16 input) and the FIR tail's 2-D
     source; and the
     halo kernel, bit for bit, over float32, int16 and complex64, 1 to 256
     samples, 1 to 8 shards, 1 to 2560 rows, strided sources, a −inf fill,
     two hops and a head for shard 0;
  4. the planar main path, `wideband.process_n`, at the HEADLINE shape
     (2560 channels, 16128 frames a chunk) on both profiles with float32
     and int16 chunks: launch counts and audio checks; then the chan-major
     main path (CHANMAJOR: the same shape, `time_major=False`,
     `pallas_fold=True`, the fft passband and the tail kernel): one fold
     and one non-FIR tail launch a chunk, audio [2560, 64512]; then ms a
     chunk, input Msamples/s, each kernel against and beside its plain
     version at HEADLINE (the channelizer also on int16 chunks, both tails
     also on USB, NBFM and AM with the hang), and where the planar and the
     CHANMAJOR device time goes, with the card's idle share;
  5. row alignment on both main paths: two AM carriers come out as the two
     loudest RSSI rows;
  6. AGC hang and squelch on the planar HEADLINE path (launch counts
     unchanged), and the chain's own entry points: `chain.process` on 2560
     receivers with the tail kernel, `chain.run_offline` for one 12 kHz and
     one 20.25 kHz receiver, and a MID chan-major run through the fused
     channelizer and the tail kernel, each held against the same call on
     the CPU;
  7. the sharded receiver chain (SHARDED: `parallel.sharded_chain.build` on
     8 receivers × 8 time shards of 131072 samples, AM with the matmul
     passband, and on a 2 × 4 chan × time grid, USB with the fft passband;
     two chained calls each): halo-kernel launches with halo_impl="rdma",
     none with "ppermute", identical audio, and the sharded audio against
     the serial chain on the card and the same call on the CPU; the halo
     kernel timed beside an empty launch, its plain version and the slice
     copy PyTorch would make;
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
     is taken at HEADLINE beside the fold kernel's.
Each kernel's line in the JSON summary carries its launches on the main
paths, its time, its plain version's, its bound on this card (bytes over
3.35 TB/s against operations over the peak rate of their type) and, where
one PyTorch call computes the same function, that call's time; the
channelizer's and the FIR tail's also their times at the mesh's shapes.
The last lines are the kernels' JSON summary and
{"ok": true, "device": {...}}. It exits non-zero, printing no result,
when no CUDA device is present. It imports nothing of JAX.
"""

from __future__ import annotations

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
    given) read through strided views and written chain-major, as the
    chain's tail tier runs it. With yT, a (re, im) pair of contiguous
    time-major planes [nf, C]: read as they lie and written time-major
    with the power row, as the time-major wideband tier runs it. tile: the
    tail tile (the peak segment) in place of the chunk's."""
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
    args = (*planes, st, chain._tail_params_vec(params, ccfg),
            params.P_interp)
    kw = dict(tile_t=tile or chain._tail_tile(nf, n_taps),
              demod=chain._tail_demod(ccfg),
              accum_pow=accum or yT is not None,
              hang_window=chain._tail_hang_window(ccfg),
              audio_layout="chan" if yT is None else "time")
    return (lambda: ct.chain_tail_am(*args, **kw),
            lambda: ct.chain_tail_am_plain(*args, **kw))


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
        _compare("chain_tail_am", f"{label} nf={n}",
                 *_am_case(C, n, gen, device=device, **kw),
                 TOL_SNR_DB["tail"], device, err)
    # time-major audio launches clusters of four blocks: also a channel
    # count that leaves the last block ragged and the last cluster short
    for label, kw, n_ch in (("AM", {}, C),
                            ("USB hang 40 ms", dict(mode="USB", hang_ms=40.0),
                             C),
                            ("AM", {}, C - 12)):
        yT = [torch.randn(nf, n_ch, generator=gen, device=device) * 0.05
              for _ in range(2)]
        _compare("chain_tail_am",
                 f"{label} time-major nf={nf}, {n_ch} channels",
                 *_am_case(n_ch, nf, gen, device=device, yT=yT, **kw),
                 TOL_SNR_DB["tail"], device, err)


def _wrappers() -> dict:
    """Each kernel's wrapper by its name in the JSON summary."""
    from supersdr_tpu_torch.ops.cuda import chain_tail as ct
    from supersdr_tpu_torch.ops.cuda import channelize_fused as cf
    from supersdr_tpu_torch.ops.cuda import halo
    from supersdr_tpu_torch.ops.cuda import pfb_fold as pf
    return {"channelize_fused": cf.channelize_fused_raw3,
            "chain_tail": ct.chain_tail_fir, "pfb_fold": pf.pfb_fold,
            "chain_tail_am": ct.chain_tail_am, "halo": halo.left_halo}


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
    if launches["pfb_fold"] or launches["chain_tail_am"] or launches["halo"]:
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
            "chain_tail_am": len(chunks), "halo": 0}
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
    _compare("chain_tail_am", f"AM nf={cfg.chunk_per_chan}", kernel, plain,
             TOL_SNR_DB["tail"], dev, err)
    times["chain_tail_am"] = (cuda_ms(kernel, iters), cuda_ms(plain, 2))
    for name in ("pfb_fold", "chain_tail_am"):
        print(f"time {name}: kernel {times[name][0]:.3f} ms, "
              f"plain {times[name][1]:.3f} ms", flush=True)
    # the other demodulators through the scanned body at this length (NBFM
    # on FM carriers with manual AGC), and AM with the hang
    for label, kw in (("USB", dict(mode="USB", y=y)),
                      ("NBFM manual AGC", dict(mode="NBFM",
                                               agc=dict(on=False))),
                      ("AM hang 500 ms", dict(hang_ms=500.0, y=y)),
                      ("AM hang 40 ms", dict(hang_ms=40.0, y=y))):
        kernel, plain = _am_case(cfg.n_chan, cfg.chunk_per_chan, gen,
                                 device=dev, **kw)
        _compare("chain_tail_am", f"{label} nf={cfg.chunk_per_chan}", kernel,
                 plain, TOL_SNR_DB["tail"], dev, err)
        print(f"time chain_tail_am {label}: kernel "
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


def phase_controls(shape: dict, device, seed: int = 5) -> None:
    """AGC hang and squelch on the planar HEADLINE path (fast profile): one
    run each, one channelizer and one FIR-tail launch a chunk as without
    them; the squelch must close on a quiet chunk after a loud one."""
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
                "pfb_fold": 0, "chain_tail_am": 0, "halo": 0}
        if launches != want or not finite \
                or (label == "squelch" and opened != 0.0):
            raise AssertionError(f"planar {label} failed")


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
    if outs["card"][1]["chain_tail_am"] != 1:
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
            or res["card"][1]["chain_tail_am"] != 1:
        raise AssertionError("chan-major mxu2fused missed a kernel")
    _close_to_cpu("chan-major mxu2fused MID", res["card"][0],
                  res["cpu"][0], tol)


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
    _compare("chain_tail_am", f"AM time-major nf={cfg.chunk_per_chan}",
             *_am_case(cfg.n_chan, cfg.chunk_per_chan, gen, device=device,
                       yT=(out.baseband.re, out.baseband.im),
                       n_taps=cfg.n_taps),
             TOL_SNR_DB["tail"], device, err)
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
         {"pfb_fold": 1, "chain_tail_am": 1, "halo": 1}))
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
    if launches["chain_tail_am"] != 2 or not snr >= TOL_SNR_DB["cpu"]:
        raise AssertionError("pipeline disagrees with the serial wideband")
    print(dryrun.dryrun_multichip(MESH_D, device), flush=True)

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


def _wide_capture(n: int, fs: int, n_chan: int, device,
                  seed: int = 21) -> np.ndarray:
    """n samples at fs: AM carriers at the centres of CLI_CARRIERS'
    channels over a noise floor far below them, made on the card."""
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
    return z.cpu().numpy()


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
        self._saved = (cf._launch, ct._launch_fir, ct._launch_am)
        cf._launch = cf.channelize_fused_plain
        ct._launch_fir, ct._launch_am = (ct.chain_tail_plain,
                                         ct.chain_tail_am_plain)
        return self

    def __exit__(self, *exc):
        cf, ct = self._mods
        cf._launch, ct._launch_fir, ct._launch_am = self._saved


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
    channels × 16128 frames; the fast tier for the channelizer and the FIR
    tail; "…_mesh": at the mesh's shapes on 8 shards, (20, 128) with 24
    planes and the FIR tail on 3072 rows), from the shapes alone."""
    from supersdr_tpu_torch.ops import channelizer
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
    n1, n2 = channelizer._pick_factors(M)
    m1, m2, m1_pad = sw.plan_mesh(cfg, MESH_D).factors
    state = (4 + per) * M * 4 * 2
    tail_flops = samples * (2 * per * L + 40)   # resampler + the scalar ops
    return {
        "channelize_fused": chan(n1, n2, n1, 1),
        "chain_tail": tail(M),
        "channelize_fused_mesh": chan(m1, m2, m1_pad, MESH_D),
        "chain_tail_mesh": tail(m1_pad * m2),
        "pfb_fold": bound_ms(
            2 * 4 * (samples + (K - 1) * M) + 4 * K * M + 8 * samples,
            {"fp32": samples * 4 * K}),
        "chain_tail_am": bound_ms(8 * samples + state + 4 * samples * L,
                                  {"fp32": tail_flops}),
        "halo": halo_bound,
    }


def _summary(name: str, source: str, replaces: str, paths: dict, err: dict,
             times: tuple, bound: tuple, library_ms=None, **extra) -> dict:
    """One kernel's line: `launches` sums its launches over the main paths
    (each driven from a zeroed count), `paths` says where they were."""
    launches = {k: v["launches"][name] for k, v in paths.items()}
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
    phase_rows(HEADLINE, dev)
    phase_rows(HEADLINE, dev, CHANMAJOR)
    phase_controls(HEADLINE, dev)
    phase_chain(dev)
    times.update(phase_halo_timing(dev))
    sharded = phase_sharded(dev)
    tmajor = phase_tmajor(dev, err, planar_ms)
    torch.cuda.empty_cache()
    mesh = phase_mesh(dev, err)
    times.update(mesh["times"])
    mesh_tiers = phase_mesh_tiers(dev)
    phase_mesh_parts(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cli_runs = phase_cli(dev, tmp)
        session = phase_session(dev, tmp)
    paths = {"planar": main_path, "chanmajor": chan, "sharded": sharded,
             "tmajor": tmajor, "mesh": mesh, "mesh_tiers": mesh_tiers,
             **cli_runs, "session": session}
    bounds = kernel_bounds(times["halo_bound"])
    kernels = [
        _summary("channelize_fused", "channelize_fused.cu",
                 "channelize_fused.py:61", paths, err,
                 times["channelize_fused_fast"], bounds["channelize_fused"],
                 mesh_ms=times["mesh_channelize_fused_fast"][0],
                 mesh_plain_ms=times["mesh_channelize_fused_fast"][1],
                 mesh_bound_ms=bounds["channelize_fused_mesh"][0]),
        _summary("chain_tail", "chain_tail.cu", "chain_tail.py:332", paths,
                 err, times["chain_tail_fast"], bounds["chain_tail"],
                 mesh_ms=times["mesh_chain_tail_fast"][0],
                 mesh_plain_ms=times["mesh_chain_tail_fast"][1],
                 mesh_bound_ms=bounds["chain_tail_mesh"][0]),
        _summary("pfb_fold", "pfb_fold.cu", "pfb_fold.py:36", paths, err,
                 times["pfb_fold"], bounds["pfb_fold"],
                 library_ms=times["pfb_fold_library"]),
        _summary("chain_tail_am", "chain_tail.cu", "chain_tail.py:304",
                 paths, err, times["chain_tail_am"],
                 bounds["chain_tail_am"]),
        _summary("halo", "halo.cu", "halo.py:24", paths, err, times["halo"],
                 bounds["halo"], library_ms=times["halo_library"],
                 empty_launch_ms=times["halo_empty"],
                 call_ms=times["halo_call"]),
    ]
    for k in kernels:
        print(f"bound {k['name']}: {k['ms']:.4f} ms against "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}), launches "
              f"{k['paths']}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
