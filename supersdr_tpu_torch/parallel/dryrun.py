"""A dry run of every mesh form at tiny shapes.

Counterpart of `__graft_entry__.dryrun_multichip`: the same steps, shapes
and assertions, on a mesh of `n_shards` shards that lives on one device.

  python3 -m supersdr_tpu_torch.parallel.dryrun [n_shards] [device]
"""

from __future__ import annotations

import sys

import numpy as np

from supersdr_tpu_torch.parallel import (dist_fft, mesh, pipeline,
                                         sharded_chain, sharded_wideband)
from supersdr_tpu_torch.runtime import chain, wideband


def _noise(rng, shape, scale: float) -> np.ndarray:
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape)) * scale
            ).astype(np.complex64)


def _wideband(cfg, n_shards: int, device, rng, **kw):
    """(process, params, state, one noise chunk) of the sharded wideband."""
    proc = sharded_wideband.build(
        cfg, sharded_wideband.make_mesh(n_shards, device), **kw)
    return (proc, sharded_wideband.make_params(cfg, device=device),
            sharded_wideband.init_state(cfg, device=device),
            _noise(rng, cfg.chunk_in, 0.05))


def dryrun_multichip(n_shards: int, device=None) -> str:
    """Run the sharded chain, the sharded wideband on its tiers and
    factorings, the distributed FFT and the pipeline once each on
    `n_shards` shards of `device` (the current CUDA device unless one is
    given), asserting shapes and factorings. Returns the summary line."""
    rng = np.random.default_rng(0)
    d = n_shards

    # ---- 1. channel × time sharded receiver chain (matmul passband)
    n_time, n_chan_mesh = d, 1
    if d % 2 == 0 and d >= 4:
        n_chan_mesh, n_time = 2, d // 2
    m = mesh.make_mesh(n_chan_mesh, n_time, device=device)
    local = 512
    n_chan = 2 * n_chan_mesh
    cfg = chain.ChainConfig(mode="USB", chunk=local, os_block=local,
                            n_taps=129, passband_impl="matmul")
    proc = sharded_chain.build(cfg, m)
    params = sharded_chain.make_params(cfg, n_chan, device=device)
    state = sharded_chain.init_state(cfg, n_chan, device=device)
    n = local * n_time
    _, out = proc(params, state, _noise(rng, (n_chan, n), 0.1))
    assert tuple(out.audio.shape) == (n_chan, n * 4)

    # ---- 2. wideband: time-sharded PFB + all_to_all + channel-parallel
    wcfg = wideband.WidebandConfig(fs_in=96_000, n_chan=d,
                                   chunk_in=d * d * 128, mode="AM",
                                   taps_per=4, n_taps=129)
    wproc, wp, ws, wiq = _wideband(wcfg, d, device, rng)
    _, audio, _ = wproc(wp, ws, wiq)
    assert audio.shape[0] == d

    # ---- 2b. the fast profile's planar form at 2 shards: (2, 256)
    fast = wideband.PROFILES["fast"]
    fcfg = wideband.WidebandConfig(fs_in=512 * 12_000, n_chan=512,
                                   chunk_in=2 * 512 * 128, mode="AM",
                                   taps_per=4, n_taps=129, **fast)
    fproc, fp, fs_, fiq = _wideband(fcfg, 2, device, rng)
    _, faudio, _ = fproc(fp, fs_, fiq)
    assert tuple(faudio.shape) == (2 * 128 * 4, 512)

    # ---- 2c. planar factorings per shard count: 4 shards on 512 channels
    # (4, 128) exactly, with int16 and float32 chunks in one process_n;
    # 8 shards on 2560 channels (20, 128) padded to 24 planes
    if d >= 4:
        c4 = wideband.WidebandConfig(fs_in=512 * 12_000, n_chan=512,
                                     chunk_in=512 * 256, mode="AM",
                                     taps_per=4, n_taps=129, **fast)
        proc4, p4, s4, z4 = _wideband(c4, 4, device, rng)
        assert proc4.planar and proc4.planar_factors == (4, 128, 4), \
            proc4.planar_factors
        re16 = (np.real(z4) * 32768).astype(np.int16)
        im16 = (np.imag(z4) * 32768).astype(np.int16)
        _, a4s, _ = proc4.process_n(p4, s4, ((re16, im16), z4))
        assert tuple(a4s[-1].shape) == (256 * 4, 512)
    if d >= 8:
        c8 = wideband.WidebandConfig(fs_in=2560 * 12_000, n_chan=2560,
                                     chunk_in=2560 * 128, mode="AM",
                                     taps_per=4, n_taps=65, **fast)
        proc8, p8, s8, z8 = _wideband(c8, 8, device, rng)
        assert proc8.planar and proc8.planar_factors == (20, 128, 24), \
            proc8.planar_factors
        _, a8, _ = proc8(p8, s8, z8)
        assert tuple(a8.shape) == (128 * 4, 2560)

    # ---- 2d. the quality profile's planar form at 2 shards
    qcfg = wideband.WidebandConfig(fs_in=512 * 12_000, n_chan=512,
                                   chunk_in=512 * 128, mode="AM",
                                   taps_per=4, n_taps=129,
                                   **wideband.PROFILES["quality"])
    qproc, qp, qs, qz = _wideband(qcfg, 2, device, rng)
    assert qproc.planar, "quality planar form must be active at 2 shards"
    _, qaudio, _ = qproc(qp, qs, qz)
    assert tuple(qaudio.shape) == (128 * 4, 512)

    # ---- 3. TP axis: distributed four-step FFT (one all_to_all)
    nfft = d * d * 128
    f = dist_fft.build_fft(nfft, dist_fft.make_mesh(d, device))
    zx = _noise(rng, nfft, 1.0)
    y = f(zx)
    got = y.re.cpu().numpy() + 1j * y.im.cpu().numpy()
    ref = np.fft.fft(zx)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4

    # ---- 4. PP axis: 2-stage pipelined wideband (send_next handoff)
    pcfg = wideband.WidebandConfig(fs_in=96_000, n_chan=8, chunk_in=8192,
                                   mode="AM", taps_per=4, n_taps=129)
    pproc = pipeline.build(pcfg, pipeline.make_mesh(device))
    _, paudio = pproc(wideband.make_params(pcfg, device=device),
                      wideband.init_state(pcfg, device=device),
                      _noise(rng, (2, pcfg.chunk_in), 0.05))
    assert paudio.shape[0] == 2

    return (f"dryrun_multichip OK on {d} shards: chain "
            f"{tuple(out.audio.shape)}, wideband {tuple(audio.shape)}, "
            f"dist_fft n={nfft}, pipeline {tuple(paudio.shape)}")


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                           sys.argv[2] if len(sys.argv) > 2 else None))
