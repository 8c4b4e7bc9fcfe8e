"""The port's mesh across processes on the CPU: its shards split over 2 and
4 processes joined by gloo, against the one-process mesh and the JAX
reference.

The processes are spawned by `supersdr_tpu_torch.parallel.launch.spawn`
(a file store under `tmp_path`, one thread each, a 60 s limit on the group
and on the join) and run the tasks of `tests/_torch_mp_workers.py`, which
imports no JAX; each process reports that JAX stayed out of it. One spawn
a process count serves the whole file. The inputs are made from numpy
seeds the same way in the processes and here.

Tolerances: the primitives, the sharded wideband, the distributed FFT and
the pipeline are held bit for bit against the one-process port (they move
or compute the same numbers in the same order). The sharded chain is held
against the JAX reference's `shard_map` on the 8 virtual CPU devices with
the bounds of `tests/test_torch_sharded_chain.py`: audio rtol 2e-3, atol
2e-4; with the fft passband the first RAMP = 1280 audio samples at atol
1e-3 (FFT rounding noise lifted by the AGC). NBFM with the AGC on runs the
matmul passband, where no FFT rounds the ramp-up, so it meets the bound
from sample 0 (with the fft passband the AGC holds the ramp-up's angle
noise for an input-dependent stretch; `test_torch_sharded_chain.py` skips
4096 samples of its own input for that). Against the one-process port the
chain is held to the same rtol 2e-3 / atol 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mp_workers as W
from supersdr_tpu.parallel import mesh as jmesh
from supersdr_tpu.parallel import sharded_chain as jsharded
from supersdr_tpu.runtime import chain as jchain
from supersdr_tpu_torch.ops.cuda import halo
from supersdr_tpu_torch.parallel import collectives, ingest, launch

AUDIO_TOL = dict(rtol=2e-3, atol=2e-4)
RAMP_TOL = dict(rtol=2e-3, atol=1e-3)
RAMP = 1280
TASKS = {2: list(W.TASKS), 4: [t for t in W.TASKS if t != "pipeline"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every task's results by process count: [rank] → {task: result}."""
    cache = {}

    def get(world: int) -> list:
        if world not in cache:
            store = tmp_path_factory.mktemp(f"world{world}") / "store"
            res = launch.spawn(W.run_tasks, world, str(store), TASKS[world],
                               timeout=60.0)
            cache[world] = res
        return cache[world]
    return get


def _task(runs, world: int, name: str) -> list:
    """One task's result on every rank; a rank's failure with its
    traceback."""
    out = []
    for r in runs(world):
        ok, v = r[name]
        assert ok, f"rank {r['rank']} of {world}:\n{v}"
        out.append(v)
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_processes_hold_no_jax(runs, world):
    assert all(r["no_jax"] and r["no_jax_after"] for r in runs(world))
    assert [r["rank"] for r in runs(world)] == list(range(world))


# ---------------------------------------------------------------- primitives
_AXES = {"halo_f32": -2, "halo_pair": -2, "halo_c64": -3,
         "halo_c64_fill": -3, "context": -2, "index": 0, "a2a_01": 0,
         "a2a_10": 0, "bcast": 0, "send": 0}


@pytest.mark.parametrize("impl", ["rdma", "ppermute"])
@pytest.mark.parametrize("world", [2, 4])
def test_primitives_equal_the_local_transport(runs, world, impl):
    """Each rank's block of every primitive is the one-process transport's
    block bit for bit: halos with a head and a fill, int16 pairs, complex,
    a 37-sample context of 8-sample shards (hops that cross ranks), the
    gathered summaries, the global shard index, both all_to_all forms,
    broadcast_last and send_next."""
    want = W.prim_results(collectives.Transport(impl), W.prim_inputs())
    got = _task(runs, world, "prims" if impl == "rdma" else "prims_ppermute")
    for k, w in want.items():
        if k == "summaries":          # every shard's, on every rank
            for g in got:
                np.testing.assert_array_equal(g[k], w)
            continue
        np.testing.assert_array_equal(
            np.concatenate([g[k] for g in got], axis=_AXES[k]), w,
            err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_counted_traffic_is_the_one_process_count(runs, world):
    """What a shard receives does not depend on how many processes hold
    the shards: every rank counts the one-process transport's bytes."""
    want = W._counted(lambda: W.prim_results(collectives.Transport(),
                                             W.prim_inputs()))
    assert _task(runs, world, "prims_traffic") == [want] * world


@pytest.mark.parametrize("mode", ["am", "nbfm"])
def test_chain_traffic_equals_the_comm_model_at_world_two(runs, mode):
    for r in _task(runs, 2, f"traffic_{mode}"):
        assert r["counted"] == r["model"]


def test_peer_destinations_of_the_halo_take_the_tail_or_the_fill():
    """The halo wrapper's `peers` (the transport's destinations in other
    processes) on the plain path: virtual shard D + i takes shard
    D + i − hop's tail, or the fill before the first shard."""
    x = torch.arange(2 * 2 * 6, dtype=torch.float32).reshape(2, 2, 6)
    out = torch.empty(2, 2, 3)
    peer = [torch.full((2, 2, 3), 7.0) for _ in range(3)]
    got = halo.left_halo(x, 3, -1.0, hop=3, out=out,
                         peers=[(peer[0], 1), (peer[1], 0), (peer[2], 1)])
    assert got is out and torch.equal(out, torch.full((2, 2, 3), -1.0))
    assert torch.equal(peer[0][:, 1], torch.full((2, 3), -1.0))   # 2 − 3
    assert torch.equal(peer[1][:, 0], x[:, 0, 3:])                 # 3 − 3
    assert torch.equal(peer[2][:, 1], x[:, 1, 3:])                 # 4 − 3
    assert torch.equal(peer[2][:, 0], torch.full((2, 3), 7.0))
    with pytest.raises(ValueError, match="within hop"):
        halo.left_halo(x, 3, hop=1, peers=[(peer[0], 0), (peer[1], 0)])
    with pytest.raises(ValueError, match="strides"):
        halo.left_halo(x, 3, peers=[(peer[0].transpose(0, 1), 0)])


# ---------------------------------------------------------------- sharded chain
def _ref_chain(case: str) -> np.ndarray:
    """The reference's sharded chain on 8 virtual devices, three chained
    calls: audio [calls, n_chan, n·4]."""
    kw, n_chan, pkw = W.CHAIN_CASES[case]
    cfg = jchain.ChainConfig(**kw)
    m = jmesh.make_mesh(n_chan=1, n_time=W.D, devices=jax.devices()[:W.D])
    proc = jsharded.build(cfg, m)
    p = jsharded.make_params(cfg, n_chan=n_chan, **pkw)
    st = jsharded.init_state(cfg, n_chan)
    iq = W.chain_iq(cfg.chunk * W.D, n_chan, W.CALLS, seed=3)
    out = []
    for k in range(W.CALLS):
        st, o = proc(p, st, jnp.asarray(iq[k]))
        out.append(np.asarray(o.audio))
    return np.stack(out)


def _one_process(fn, *args):
    """fn in this process on one thread, as each spawned process runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(W.CHAIN_CASES))
def test_sharded_chain_over_processes_matches_reference(runs, case, world):
    """8 time shards over the processes, three chained calls: the audio
    the ranks return, side by side, against the reference's sharded chain
    and against the one-process port; the stream state every rank ends
    with is the one-process port's."""
    got = _task(runs, world, f"chain_{case}")
    audio = np.concatenate([g["audio"] for g in got], axis=-1)
    ref = _ref_chain(case)
    if W.CHAIN_CASES[case][0].get("passband_impl") == "matmul":
        np.testing.assert_allclose(audio, ref, **AUDIO_TOL)
    else:
        np.testing.assert_allclose(audio[0, :, :RAMP], ref[0, :, :RAMP],
                                   **RAMP_TOL)
        np.testing.assert_allclose(audio[0, :, RAMP:], ref[0, :, RAMP:],
                                   **AUDIO_TOL)
        np.testing.assert_allclose(audio[1:], ref[1:], **AUDIO_TOL)
    one = _one_process(W.chain_run, case, 1)
    np.testing.assert_allclose(audio, one["audio"], **AUDIO_TOL)
    for g in got:
        for a, b in zip(g["state"], one["state"]):
            np.testing.assert_allclose(a, b, **AUDIO_TOL)


# ---------------------------------------------------------------- wideband
@pytest.mark.parametrize("case", list(W.WB_CASES))
def test_sharded_wideband_over_two_processes_equals_one(runs, case):
    """8 shards over 2 processes on the planar and the fallback tier, a
    float32 then an int16 chunk: every rank's gathered audio and RSSI rows
    and gathered serial state equal the one-process mesh's (the same
    `channel_order`, so by frequency)."""
    one = _one_process(W.wb_run, case, 1)
    assert one["tier"] == W.WB_CASES[case][2]
    got = _task(runs, 2, f"wb_{case}")
    for g in got:
        assert g["tier"] == one["tier"]
        np.testing.assert_array_equal(g["order"], one["order"])
        for a, b in zip(g["audio"] + g["rssi"], one["audio"] + one["rssi"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(g["state"], one["state"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_each_process_holds_its_share_of_the_rows(runs, world):
    """After the reshard a process's rows are its planes (planar: 1024
    rows of (8, 128)) or its bins (fallback: 16)."""
    for case, n in (("planar", 1024), ("fallback", 16)):
        per = n // world
        assert [g["rows"] for g in _task(runs, world, f"wb_{case}")] == \
            [(r * per, (r + 1) * per) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_dist_fft_over_processes_equals_one(runs, world):
    one = _one_process(W.fft_run, 1)
    for g in _task(runs, world, "fft"):
        np.testing.assert_array_equal(g, one)


def test_pipeline_stages_in_two_processes_equal_one(runs):
    """Stage 0 in rank 0, stage 1 in rank 1, the handoff between them,
    the AGC on: both ranks return the one-process pipeline's audio and
    state."""
    one = _one_process(W.pipe_run, 1)
    for g in _task(runs, 2, "pipeline"):
        np.testing.assert_array_equal(g["audio"], one["audio"])
        for a, b in zip(g["state"], one["state"]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- ingest
@pytest.mark.parametrize("world", [2, 4])
def test_ingest_gives_each_process_its_range(runs, world):
    n = W.D * 1024
    iq = W.chain_iq(n, 2, 1, seed=9)[0]
    per = n // world
    for r, g in enumerate(_task(runs, world, "ingest")):
        assert g["range"] == (r * per, (r + 1) * per)
        assert g["d_local"] == W.D // world
        assert g["refuses_the_whole_capture"]
        np.testing.assert_array_equal(
            g["block"], iq[:, r * per:(r + 1) * per].reshape(
                2, W.D // world, 1024))


def test_initialize_distributed_picks_gloo_with_a_card(tmp_path,
                                                       monkeypatch):
    """The default backend is gloo even where a card is present (NCCL
    refuses two ranks on one card); `backend` passes the caller's
    choice."""
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for kw in ({}, {"backend": "gloo"}):
        ingest.initialize_distributed(f"file://{tmp_path}/store{len(kw)}",
                                      1, 0, **kw)
        try:
            assert dist.get_backend() == "gloo"
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_peer_buffers_refuse_processes_on_different_cards(runs, world):
    """Every rank compares the card ids of all ranks before it maps a
    buffer: ranks on different cards are refused, naming what is not
    built."""
    for msg in _task(runs, world, "one_card"):
        assert f"use {world} cards" in msg and "across cards" in msg


def test_one_card_check_passes_one_card_and_refuses_two():
    from supersdr_tpu_torch.ops.cuda import peer
    peer.check_one_card(["GPU-a", "GPU-a", "GPU-a"])
    with pytest.raises(ValueError, match="2 cards.*across cards"):
        peer.check_one_card(["GPU-a", "GPU-b", "GPU-a"])


def test_process_transport_refuses_a_group_that_is_not_gloo(tmp_path,
                                                            monkeypatch):
    """An NCCL group holds one card a process: across cards, which is not
    built, so the transport refuses it rather than run untried."""
    import torch.distributed as dist
    ingest.initialize_distributed(f"file://{tmp_path}/store", 1, 0)
    try:
        monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
        with pytest.raises(ValueError, match="gloo group, not nccl"):
            collectives.ProcessTransport("cpu")
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def test_mesh_needs_a_group_for_more_than_one_process():
    from supersdr_tpu_torch.parallel import mesh
    with pytest.raises(ValueError, match="process group has 1"):
        mesh.time_mesh(8, device="cpu", world=2)
    with pytest.raises(RuntimeError, match="initialised"):
        collectives.ProcessTransport("cpu")
    assert mesh.time_mesh(8, device="cpu").comm.world == 1


def test_dryrun_splits_its_shards_over_two_processes():
    from supersdr_tpu_torch.parallel import dryrun
    line = dryrun.dryrun_processes(8, "cpu", 2, timeout=120.0)
    assert line.startswith("dryrun_multichip OK on 8 shards")
    assert line.endswith("over 2 processes")


# ---------------------------------------------------------------- launcher
def test_spawn_reports_the_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*"
                                           "rank one fails"):
        launch.spawn(W.fail_on_rank_one, 2, str(tmp_path / "store"),
                     timeout=60.0)
