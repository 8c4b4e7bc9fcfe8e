"""What each process runs in tests/test_torch_multiprocess.py.

The processes are spawned by `supersdr_tpu_torch.parallel.launch.spawn`
and joined by a gloo group; every mesh they make splits its time shards
over them. This module imports nothing of JAX (each task asserts it), so
the processes hold the port alone. The inputs are made from numpy seeds
identically in every process and in the test, which holds each process's
block against the one-process port and the JAX reference. Results go back
as numpy arrays."""

from __future__ import annotations

import sys
import traceback

import numpy as np
import torch

from supersdr_tpu_torch.parallel import (collectives, dist_fft, ingest, mesh,
                                         pipeline, sharded_chain,
                                         sharded_wideband)
from supersdr_tpu_torch.runtime import chain, wideband
from supersdr_tpu_torch.utils import held

D = 8                                   # time shards of every case


# ---------------------------------------------------------------- inputs
def prim_inputs() -> dict:
    """Global tensors of D shards for each primitive's case."""
    rng = np.random.default_rng(5)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def i16(*shape):
        return torch.from_numpy(
            (rng.normal(size=shape) * 3000).astype(np.int16))
    c64 = torch.complex(f32(3, D, 64), f32(3, D, 64))
    return {
        "halo_f32": f32(3, D, 64), "head_f32": f32(3, 16),
        "halo_pair": (i16(2, 2, D, 32), i16(2, 2, D, 32)),
        "halo_c64": c64, "head_c64": torch.complex(f32(3, 16), f32(3, 16)),
        "ctx": f32(2, D, 8), "summary": f32(3, D, 1),
        "a2a": f32(D, 16, 24), "bcast": f32(D, 3), "send": f32(D, 3, 2),
    }


def prim_results(comm, x: dict) -> dict:
    """Every primitive on the global inputs `x`, through `comm` (this
    process's block of each): the one-process transport gives all D."""
    def block(t, axis):
        d = t.shape[axis] // comm.world
        return t.narrow(axis, comm.rank * d, d)
    out = {
        "halo_f32": comm.left_halo(block(x["halo_f32"], -2), 16, 0.5,
                                   head0=x["head_f32"]),
        "halo_pair": comm.left_halo(tuple(block(p, -2)
                                          for p in x["halo_pair"]), 7, -3.0),
        "halo_c64": comm.left_halo(block(x["halo_c64"], -2), 16,
                                   head0=x["head_c64"]),
        "halo_c64_fill": comm.left_halo(block(x["halo_c64"], -2), 64, 2.0),
        # 37 samples of 8-sample shards: five hops, across ranks
        "context": comm.left_context(block(x["ctx"], -2), 37, -np.inf),
        "summaries": comm.gather_summaries(block(x["summary"], -2)),
        "index": comm.shard_index(block(x["summary"], -2)),
        "a2a_01": comm.all_to_all(block(x["a2a"], 0), 0, 1),
        "a2a_10": comm.all_to_all(block(x["a2a"], 0), 1, 0),
        "bcast": comm.broadcast_last(block(x["bcast"], 0)),
        "send": comm.send_next(block(x["send"], 0)),
    }
    return {k: np.stack([p.numpy() for p in v]) if isinstance(v, tuple)
            else (torch.view_as_real(v) if v.is_complex() else v).numpy()
            for k, v in out.items()}


def chain_iq(n: int, n_chan: int, calls: int, seed: int) -> np.ndarray:
    """[calls, n_chan, n] complex64: a tone per receiver over noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(calls * n) / 12000
    out = []
    for c in range(n_chan):
        tone = np.exp(2j * np.pi * (800 + 400 * c) * t)
        noise = 0.05 * (rng.normal(size=t.size) + 1j * rng.normal(size=t.size))
        out.append(tone + noise)
    return np.stack(out).astype(np.complex64).reshape(
        n_chan, calls, n).transpose(1, 0, 2).copy()


AGC_ON = dict(on=True, thresh_db=-80, decay_ms=1000)
# id: (config keywords, receivers, params keywords)
CHAIN_CASES = {
    "am-matmul": (dict(mode="AM", chunk=1024, os_block=1024,
                       passband_impl="matmul"), 2, dict(agc_kwargs=AGC_ON)),
    "usb-fft": (dict(mode="USB", chunk=1024, os_block=1024), 2,
                dict(agc_kwargs=AGC_ON)),
    "nbfm-agc": (dict(mode="NBFM", chunk=1024, os_block=1024,
                      passband_impl="matmul"), 2, dict(agc_kwargs=AGC_ON)),
}
CALLS = 3


def chain_run(case: str, world=None) -> dict:
    """Three chained calls of the sharded chain on D time shards: this
    process's audio, RSSI and baseband blocks, and the final state's
    leaves."""
    kw, n_chan, pkw = CHAIN_CASES[case]
    cfg = chain.ChainConfig(**kw)
    m = mesh.time_mesh(D, device="cpu", world=world)
    proc = sharded_chain.build(cfg, m)
    p = sharded_chain.make_params(cfg, n_chan, device="cpu", **pkw)
    st = sharded_chain.init_state(cfg, n_chan, device="cpu")
    iq = chain_iq(cfg.chunk * D, n_chan, CALLS, seed=3)
    lo, hi = ingest.local_time_range(iq.shape[-1], m)
    audio, rssi = [], []
    for k in range(CALLS):
        blk = ingest.make_global_iq(iq[k][:, lo:hi], iq[k].shape, m)
        st, out = proc(p, st, blk.flatten(-2))
        audio.append(out.audio.numpy())
        rssi.append(out.rssi.numpy())
    return {"audio": np.stack(audio), "rssi": np.stack(rssi),
            "state": [v.numpy() for v in held.leaves(st)]}


def chain_traffic(mode: str, world=None) -> dict:
    """What `collectives.traffic` counts for one call of the sharded chain
    (3 receivers), and the comm model's bytes."""
    from supersdr_tpu_torch.parallel import comm_model
    cfg = chain.ChainConfig(mode=mode, chunk=1024, os_block=1024)
    m = mesh.time_mesh(D, device="cpu", world=world)
    proc = sharded_chain.build(cfg, m)
    iq = chain_iq(cfg.chunk * D, 3, 1, seed=4)[0]
    lo, hi = ingest.local_time_range(iq.shape[-1], m)
    collectives.traffic.reset()
    proc(sharded_chain.make_params(cfg, 3, device="cpu"),
         sharded_chain.init_state(cfg, 3, device="cpu"), iq[:, lo:hi])
    t = collectives.traffic
    model = comm_model.chain_comm_model(cfg, D, n_chan_local=3)
    return {"counted": (t.halo_bytes, t.summary_bytes, t.total_bytes),
            "model": (model["halo_bytes"], model["summary_bytes"],
                      model["total_bytes"])}


# id: (config keywords, planar_waste_max, tier)
WB_CASES = {
    "planar": (dict(fs_in=1024 * 12_000, n_chan=1024, chunk_in=1024 * 256,
                    taps_per=4, n_taps=129, mode="AM",
                    **wideband.PROFILES["fast"]), None, "planar"),
    "fallback": (dict(fs_in=96_000, n_chan=16, chunk_in=16 * 8 * 128,
                      mode="AM", taps_per=4, n_taps=129), None, "fallback"),
}


def wb_chunks(cfg_kw: dict) -> np.ndarray:
    rng = np.random.default_rng(11)
    n = cfg_kw["chunk_in"]
    return ((rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n)))
            * 0.05).astype(np.complex64)


def wb_run(case: str, world=None) -> dict:
    """Two chunks (float32, then int16) through the sharded wideband on D
    shards, two chained calls: the gathered audio and RSSI rows, and the
    serial state gathered from the processes' rows."""
    kw, wmax, _ = WB_CASES[case]
    cfg = wideband.WidebandConfig(**kw)
    proc = sharded_wideband.build(
        cfg, sharded_wideband.make_mesh(D, device="cpu", world=world),
        planar_waste_max=wmax)
    p = wideband.make_params(cfg, device="cpu")
    st = proc.local_state(wideband.init_state(cfg, device="cpu"))
    z = wb_chunks(kw)
    i16 = tuple((part * 32768).astype(np.int16)
                for part in (z[1].real, z[1].imag))
    audio, rssi = [], []
    dim = 1 if cfg.time_major else 0
    for chunk in (z[0], i16):
        st, a, r = proc(p, st, chunk)
        audio.append(proc.gather_rows(a, dim).numpy())
        rssi.append(proc.gather_rows(r, 0).numpy())
    full = proc.gather_state(st)
    return {"audio": audio, "rssi": rssi, "tier": proc.tier,
            "order": np.asarray(proc.channel_order), "rows": proc.rows,
            "state": [v.numpy() for v in held.leaves(full)]}


def fft_run(world=None) -> np.ndarray:
    n = D * D * 128
    rng = np.random.default_rng(7)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    m = dist_fft.make_mesh(D, device="cpu", world=world)
    y = dist_fft.build_fft(n, m)(x)
    return y.re.numpy() + 1j * y.im.numpy()


PIPE = dict(fs_in=96_000, n_chan=8, chunk_in=16384, mode="AM", taps_per=8,
            n_taps=129)


def pipe_run(world=None) -> dict:
    cfg = wideband.WidebandConfig(**PIPE)
    rng = np.random.default_rng(0)
    mbs = ((rng.normal(size=(3, PIPE["chunk_in"]))
            + 1j * rng.normal(size=(3, PIPE["chunk_in"]))) * 0.1
           ).astype(np.complex64)
    p = wideband.make_params(cfg, device="cpu",
                             agc_kwargs=dict(on=True, decay_ms=500))
    st, audio = pipeline.build(cfg, pipeline.make_mesh("cpu", world=world))(
        p, wideband.init_state(cfg, device="cpu"), mbs)
    return {"audio": audio.numpy(),
            "state": [v.numpy() for v in held.leaves(st)]}


def ingest_run(world=None) -> dict:
    m = mesh.time_mesh(D, device="cpu", world=world)
    n = D * 1024
    iq = chain_iq(n, 2, 1, seed=9)[0]
    lo, hi = ingest.local_time_range(n, m)
    g = ingest.make_global_iq(iq[:, lo:hi], iq.shape, m)
    try:
        ingest.make_global_iq(iq, iq.shape, m)
        refused = False
    except ValueError:
        refused = True
    return {"range": (lo, hi), "block": g.numpy(), "d_local": m.d_local,
            "refuses_the_whole_capture": refused}


def one_card_run(world=None) -> str:
    """The peer buffers of processes that report different cards (each
    rank's card id made up): refused before anything touches a card."""
    import torch.distributed as dist

    from supersdr_tpu_torch.ops.cuda import peer
    rank = dist.get_rank()
    card_id = peer._card_id
    peer._card_id = lambda device: f"card-{rank}"
    try:
        peer.PeerSlots(torch.device("cuda", 0), rank, dist.get_world_size())
    except ValueError as e:
        return str(e)
    finally:
        peer._card_id = card_id
    return "not refused"


# ---------------------------------------------------------------- tasks
TASKS = {
    "prims": lambda w: prim_results(
        mesh.time_mesh(D, device="cpu", world=w).comm, prim_inputs()),
    "prims_ppermute": lambda w: prim_results(
        mesh.time_mesh(D, device="cpu", world=w).comm.using("ppermute"),
        prim_inputs()),
    "prims_traffic": lambda w: _counted(lambda: prim_results(
        mesh.time_mesh(D, device="cpu", world=w).comm, prim_inputs())),
    **{f"chain_{c}": (lambda w, c=c: chain_run(c, w)) for c in CHAIN_CASES},
    "traffic_am": lambda w: chain_traffic("AM", w),
    "traffic_nbfm": lambda w: chain_traffic("NBFM", w),
    **{f"wb_{c}": (lambda w, c=c: wb_run(c, w)) for c in WB_CASES},
    "fft": fft_run, "pipeline": pipe_run, "ingest": ingest_run,
    "one_card": one_card_run,
}


def fail_on_rank_one(rank: int, world: int) -> int:
    if rank == 1:
        raise ArithmeticError("rank one fails")
    return rank


def _counted(fn) -> tuple:
    collectives.traffic.reset()
    fn()
    t = collectives.traffic
    return (t.halo_bytes, t.summary_bytes, t.a2a_bytes, t.carry_bytes,
            t.send_bytes, t.n_collectives)


def run_tasks(rank: int, world: int, names: list) -> dict:
    """Each named task in this process: {name: (True, result)} or (False,
    traceback); a task that fails leaves the others to run (every process
    fails the same task, so the collectives stay matched)."""
    assert "jax" not in sys.modules, "a process imported JAX"
    torch.manual_seed(0)
    out = {"no_jax": "jax" not in sys.modules, "rank": rank}
    for name in names:
        try:
            out[name] = (True, TASKS[name](None))
        except Exception:
            out[name] = (False, traceback.format_exc())
    out["no_jax_after"] = "jax" not in sys.modules
    return out
