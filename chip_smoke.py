"""Smoke test of the PyTorch port on one CUDA card (an H100, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. card identity (torch / CUDA versions, nvidia-smi name and power limit);
  2. build both kernels from supersdr_tpu_torch/csrc with nvcc;
  3. each kernel's wrapper against its plain PyTorch version on the card,
     at the MID shape (2560 channels, 512 frames a chunk): the channelizer
     on both tiers with float32 and int16 input, the tail on AM (both
     tiers), USB and NBFM; plus ragged last tiles (13 and 640 frames);
  4. the port's main path, `wideband.process_n`, at the HEADLINE shape
     (2560 channels, 16128 frames a chunk) on both profiles with float32
     and int16 chunks: launch counts and audio checks; then ms a chunk,
     and each kernel against and beside its plain version at HEADLINE;
  5. row alignment: two AM carriers come out as the two loudest RSSI rows.
The last lines are the kernels' JSON summary and
{"ok": true, "device": {...}}. It exits non-zero, printing no result,
when no CUDA device is present. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

MID = dict(fs_in=30_720_000, n_chan=2560, chunk_in=2560 * 512, mode="AM",
           taps_per=8, n_taps=257, audio_rate=48_000)
HEADLINE = dict(MID, chunk_in=2560 * (16384 - 256))

# kernel vs plain on the card. Both compute in float32 with other
# summation orders (the tail's plain version also scans in tiles where the
# kernel is sequential); the bf16 tier's raw planes are rounded to bf16
# on output, where an order-level difference can flip one bf16 ulp.
TOL_SNR_DB = {"chan_fast": 50.0, "chan_quality": 100.0, "tail": 80.0}


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


def _chan_case(cfg, params, gen, *, i16: bool, device,
               nf: int | None = None):
    """(wrapper call, plain call) of the channelizer on one random chunk of
    nf frames (default: the config's)."""
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
              out_dtype=torch.bfloat16 if fast else torch.float32)

    def kernel():
        return cf.channelize_fused_raw3(plan, params.W_pfb, carry, x,
                                        **kw)[1]

    def plain():
        args, pkw = cf.prepare(plan, params.W_pfb, carry, *x, **kw)
        return cf.channelize_fused_plain(*args, **pkw)
    return kernel, plain


def _tail_case(cfg, params, gen, *, device, raw=None):
    """(wrapper call, plain call) of the tail on raw planes (random ones
    unless given), random history and a fresh state."""
    from supersdr_tpu_torch.ops import fir_matmul
    from supersdr_tpu_torch.ops.cuda import chain_tail as ct
    from supersdr_tpu_torch.runtime import chain
    from supersdr_tpu_torch.runtime import wideband as wb
    ccfg = cfg.chain_cfg
    n1, n2 = wb._factors_for(cfg)
    nf, C, ov = ccfg.chunk, cfg.n_chan, cfg.n_taps - 1
    PER = ccfg.interp_plan.per
    fast = cfg.passband_precision == "default"
    if raw is None:
        raw = [torch.randn(n1, nf, n2, generator=gen, device=device) * 0.05
               for _ in range(2)]
        if fast:
            raw = [r.to(torch.bfloat16) for r in raw]
    head = [torch.randn(ov, C, generator=gen, device=device) * 0.05
            for _ in range(2)]
    st = torch.zeros(4 + PER, C, device=device)
    st[2] = -120.0
    tile = chain._tail_tile(ccfg.chunk, ccfg.n_taps)
    B, n_prev = fir_matmul.tail_fir_block(ccfg.chunk, ccfg.n_taps, tile)
    args = (*raw, *head, st, chain._tail_params_vec(params.chain, ccfg),
            params.chain.W_tailpass, params.chain.P_interp)
    kw = dict(n_taps=cfg.n_taps, B=B, n_prev=n_prev, tile_t=tile,
              demod=chain._tail_demod(ccfg), fir_bf16=fast, rs_bf16=False)
    return (lambda: ct.chain_tail_fir(*args, **kw),
            lambda: ct.chain_tail_plain(*args, **kw))


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


TAIL_CASES = (("fast", "AM", None), ("quality", "AM", None),
              ("quality", "USB", None), ("quality", "NBFM", dict(on=False)))


def phase_kernels(shape: dict, device, err: dict, seed: int = 7) -> None:
    """Each kernel's wrapper against its plain version on the same inputs:
    the channelizer on both tiers with f32 and i16 input, and with a
    ragged last block of frames (13 frames); the tail on AM (both tiers),
    USB and NBFM, and with a ragged last time tile (640 frames)."""
    from supersdr_tpu_torch.runtime import wideband as wb
    gen = torch.Generator(device=device).manual_seed(seed)
    for prof in ("fast", "quality"):
        cfg = wb.WidebandConfig(**shape, **wb.PROFILES[prof])
        params = wb.make_params(cfg, device=device)
        for i16, nf in ((False, None), (True, None), (False, 13)):
            label = (f"{prof} {'i16' if i16 else 'f32'} "
                     f"nf={nf or cfg.chunk_per_chan}")
            _compare("channelize_fused", label,
                     *_chan_case(cfg, params, gen, i16=i16, device=device,
                                 nf=nf),
                     TOL_SNR_DB["chan_" + prof], device, err)
    ragged = dict(shape, chunk_in=shape["n_chan"] * 640)
    cases = [(shape, c) for c in TAIL_CASES] + [
        (ragged, ("fast", "AM", None)), (ragged, ("quality", "USB", None))]
    for shp, (prof, mode, agc) in cases:
        cfg = wb.WidebandConfig(**dict(shp, mode=mode), **wb.PROFILES[prof])
        params = wb.make_params(cfg, device=device, agc_kwargs=agc)
        _compare("chain_tail", f"{prof} {mode} nf={cfg.chunk_per_chan}",
                 *_tail_case(cfg, params, gen, device=device),
                 TOL_SNR_DB["tail"], device, err)


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
    cf.channelize_fused_raw3.launches = 0
    ct.chain_tail_fir.launches = 0
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
    launches = {"channelize_fused": cf.channelize_fused_raw3.launches,
                "chain_tail": ct.chain_tail_fir.launches}
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
        gen = torch.Generator(device=dev).manual_seed(seed)
        label = f"{prof} nf={cfg.chunk_per_chan}"
        kernel, plain = _chan_case(cfg, params, gen, i16=False, device=dev)
        _compare("channelize_fused", label, kernel, plain,
                 TOL_SNR_DB["chan_" + prof], dev, err)
        times[f"channelize_fused_{prof}"] = (cuda_ms(kernel, iters),
                                             cuda_ms(plain, 2))
        raw = kernel()
        kernel, plain = _tail_case(cfg, params, gen, device=dev, raw=raw)
        _compare("chain_tail", f"{label} AM", kernel, plain,
                 TOL_SNR_DB["tail"], dev, err)
        times[f"chain_tail_{prof}"] = (cuda_ms(kernel, iters),
                                       cuda_ms(plain, 2))
        for name in ("channelize_fused", "chain_tail"):
            k_ms, p_ms = times[f"{name}_{prof}"]
            print(f"time {name} {prof}: kernel {k_ms:.3f} ms, "
                  f"plain {p_ms:.3f} ms", flush=True)
    return times


def phase_rows(shape: dict, device, rows=(7, 1300), seed: int = 31) -> None:
    """AM carriers at channel_freqs(cfg)[r] must be the loudest RSSI rows."""
    from supersdr_tpu_torch.ops import cx
    from supersdr_tpu_torch.runtime import wideband as wb
    cfg = wb.WidebandConfig(**shape, **wb.PROFILES["fast"])
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
    print(f"rows: loudest RSSI rows {top} "
          f"({[round(float(rssi[i]), 2) for i in top]} dB), "
          f"carriers at rows {sorted(rows)}", flush=True)
    if top != sorted(rows):
        raise AssertionError("row alignment failed")


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
    _, log = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas", line.strip(), flush=True)
    err: dict = {}
    phase_kernels(MID, dev, err)
    main_path = phase_main_path(HEADLINE, dev)
    times = phase_timing(main_path["runs"], err)
    phase_rows(HEADLINE, dev)
    kernels = [
        {"name": "channelize_fused", "route": "cuda",
         "source": "supersdr_tpu_torch/csrc/channelize_fused.cu",
         "replaces": "supersdr_tpu/ops/pallas/channelize_fused.py:61",
         "launches": main_path["launches"]["channelize_fused"],
         "max_abs_err": err["channelize_fused"],
         "ms": times["channelize_fused_fast"][0],
         "plain_ms": times["channelize_fused_fast"][1]},
        {"name": "chain_tail", "route": "cuda",
         "source": "supersdr_tpu_torch/csrc/chain_tail.cu",
         "replaces": "supersdr_tpu/ops/pallas/chain_tail.py:332",
         "launches": main_path["launches"]["chain_tail"],
         "max_abs_err": err["chain_tail"],
         "ms": times["chain_tail_fast"][0],
         "plain_ms": times["chain_tail_fast"][1]},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
