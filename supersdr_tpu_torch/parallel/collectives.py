"""What moves between shards: halos, contexts, scan summaries, the
all_to_all reshard, broadcasts and stage handoffs.

Inside `shard_map` the reference gets these from `jax.lax` (`ppermute`,
`all_gather`, `all_to_all`, `axis_index`: `supersdr_tpu/ops/scans.py`,
`supersdr_tpu/parallel/`). Here a sharded tensor carries its shards on an
explicit axis — `[*batch, D, n_local]` for the time-sharded halos and
scans, a leading `[D, …]` for the reshard, the broadcast and the handoff —
and a transport's methods are the whole traffic between shards. Every
module above this one (the mesh scans, the demodulators, the AGC, the
sharded chain and wideband pipeline, the distributed FFT, the pipeline)
reaches other shards only through them.

Two transports stand behind the same methods. A mesh carries its own
(`parallel/mesh.Mesh.comm`, `sharded_wideband.Mesh.comm`), and the ops take
it as `comm`:

  Transport         every shard in this process: the tensor axis holds all
                    D shards (the module-level functions below are this
                    transport's, for callers that hold every shard);
  ProcessTransport  `world` processes of a `torch.distributed` group, rank
                    r holding global shards r·D_local … (r + 1)·D_local − 1,
                    D_local = D / world, on its tensor axis. Each method
                    gives every rank its block of what `Transport` gives for
                    all D shards, bit for bit. On CPU tensors the data goes
                    over gloo; on CUDA tensors through receive buffers
                    mapped between the processes with CUDA IPC
                    (`ops/cuda/peer.py`): the halo kernel pushes into them
                    from its pointer table, the rest is `copy_`, ordered by
                    IPC events and a host handshake on the gloo group. No
                    data crosses the host and nothing uses NCCL, which
                    refuses two ranks on one card. That form is built and
                    checked with every process on one card; across cards the
                    same tables would hold NVLink peer pointers, which is
                    neither built nor measured.

`traffic` counts, in plain integers, the bytes a real mesh would move for
each call: per shard, received, as `parallel/comm_model.py` reckons them
(a halo of n samples over R rows is R·n·itemsize; a gathered summary is
D·R·itemsize; an all_to_all (D−1)/D of a shard's buffer; a broadcast or a
handoff one shard's value), with D the global shard count, so the count is
the same on every rank and for any number of processes. Not counted, as
the reference's model does not count them: `replicate` (the stream state
the last shard hands every rank, which the reference gets from a sharding
constraint) and `gather` (collecting output for a caller).
"""

from __future__ import annotations

import copy
import math

import torch

from supersdr_tpu_torch.ops.cuda import halo
from supersdr_tpu_torch.utils import held

HALO_IMPLS = ("rdma", "ppermute")


class Traffic:
    """Bytes received by one time shard, and the count of collectives."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.halo_bytes = 0
        self.summary_bytes = 0
        self.a2a_bytes = 0
        self.carry_bytes = 0
        self.send_bytes = 0
        self.n_collectives = 0

    @property
    def total_bytes(self) -> int:
        return (self.halo_bytes + self.summary_bytes + self.a2a_bytes
                + self.carry_bytes + self.send_bytes)


traffic = Traffic()


def _rows(t: torch.Tensor) -> int:
    return math.prod(t.shape[:-2])


def _shard_bytes(t: torch.Tensor) -> int:
    """Bytes of one shard's value of a `[D, …]` tensor."""
    return math.prod(t.shape[1:]) * t.element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _align(n: int) -> int:
    return -(-n // 256) * 256


def _span(t: torch.Tensor) -> int:
    """Elements from a tensor's first to its last, strides included."""
    if t.numel() == 0:
        return 0
    return 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))


def _refill(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    vals = [None if v is None else _refill(v, it) for v in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


class Transport:
    """Every shard in this process. `impl` moves the halos: "rdma" the
    halo kernel on CUDA tensors, "ppermute" plain slice copies; on the CPU
    both are the plain version."""

    rank = 0
    world = 1

    def __init__(self, impl: str = "rdma"):
        if impl not in HALO_IMPLS:
            raise ValueError(f"halo_impl must be one of {HALO_IMPLS}")
        self.impl = impl

    def using(self, impl: str) -> "Transport":
        """This transport, its halos moved by `impl` (the buffers and
        ordering of a process transport are shared with it)."""
        if impl not in HALO_IMPLS:
            raise ValueError(f"halo_impl must be one of {HALO_IMPLS}")
        t = copy.copy(self)
        t.impl = impl
        return t

    # ---- halos
    def left_halo(self, x, n: int, fill: float = 0.0, *, head0=None):
        """The last `n` samples of the left neighbour's block, `[*batch,
        D, n]`; global shard 0 receives `fill`, or `head0` `[*batch, n]`
        (the carried stream state) when given. x: float32, int16 or
        complex64 `[*batch, D, n_local]`, or an (re, im) pair of
        planes."""
        return self._exchange(x, n, fill, 1, head0, None)

    def left_context(self, x: torch.Tensor, n: int, fill: float = 0.0
                     ) -> torch.Tensor:
        """Like `left_halo` for contexts longer than one shard: the last
        `n` samples of the stream before each shard, `[*batch, D, n]`,
        from the preceding ceil(n / n_local) shards (`fill` past the
        stream's start). One exchange a hop, each moving only the samples
        the context keeps."""
        local = x.shape[-1]
        hops = -(-n // local)
        out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype,
                          device=x.device)
        for h in range(hops, 0, -1):
            m = n - (hops - 1) * local if h == hops else local
            lo = n - h * local if h < hops else 0
            self._exchange(x, m, fill, h, None, out[..., lo:lo + m])
        return out

    def _exchange(self, x, n, fill, hop, head0, out):
        first = x if isinstance(x, torch.Tensor) else x[0]
        n_planes = 1 if isinstance(x, torch.Tensor) else len(x)
        traffic.halo_bytes += _rows(first) * n * first.element_size() \
            * n_planes
        traffic.n_collectives += 1
        return self._halo(x, n, fill, hop, head0, out)

    def _halo_fn(self):
        return halo.left_halo if self.impl == "rdma" else \
            halo.left_halo_plain

    def _halo(self, x, n, fill, hop, head0, out):
        return self._halo_fn()(x, n, fill, hop=hop, head0=head0, out=out)

    # ---- scans
    def gather_summaries(self, s: torch.Tensor) -> torch.Tensor:
        """Every shard's summary at every shard: `[*batch, D_local, 1]` →
        `[D, *batch, 1]` (the reference's `all_gather`; in one process a
        view)."""
        traffic.summary_bytes += s.shape[-2] * self.world * _rows(s) \
            * s.element_size()
        traffic.n_collectives += 1
        return self.gather(s.movedim(-2, 0), 0)

    def shard_index(self, x: torch.Tensor) -> torch.Tensor:
        """Each shard's global index along the time axis, `[D_local, 1]`,
        broadcasting against `[*batch, D_local, n]` (the reference's
        `axis_index`)."""
        d = x.shape[-2]
        return torch.arange(self.rank * d, (self.rank + 1) * d,
                            device=x.device)[:, None]

    # ---- reshard, broadcast, handoff
    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int
                   ) -> torch.Tensor:
        """The reference's tiled `jax.lax.all_to_all` over a leading shard
        axis: x `[D, *s]` → `[D, *s']`, where shard j receives block j of
        every shard's `split_axis` (which D must divide) and lays them
        side by side along `concat_axis`, in shard order (axes count from
        0 within a shard's `[*s]`). In one process one permute-and-copy:
        the result is contiguous."""
        d = x.shape[0]
        D = d * self.world
        s = list(x.shape[1:])
        if s[split_axis] % D:
            raise ValueError(f"split axis {split_axis} of {tuple(s)} does "
                             f"not divide by {D} shards")
        y = x.reshape(d, *s[:split_axis], D, s[split_axis] // D,
                      *s[split_axis + 1:])
        y = self._a2a(y, 1 + split_axis)  # [src, …, dst, block, …]
        y = y.movedim(1 + split_axis, 0)  # [dst, src, *s with the block]
        y = y.movedim(1, 1 + concat_axis)  # src right before concat_axis
        s[split_axis] //= D
        s[concat_axis] *= D
        traffic.a2a_bytes += _shard_bytes(x) * (D - 1) // D
        traffic.n_collectives += 1
        return y.reshape(d, *s).contiguous()

    def _a2a(self, y: torch.Tensor, ax: int) -> torch.Tensor:
        """y [D, …, D, block, …] (the destination axis at `ax`) → the
        same with every source shard's blocks for this rank's
        destinations: in one process y itself."""
        return y

    def broadcast_last(self, v: torch.Tensor) -> torch.Tensor:
        """The last shard's value at every shard: `[D, *s]` → `[D, *s]`
        (the reference's `bcast_last`: a binomial ppermute tree of
        ceil(log2 D) rounds, in which each shard receives the value once;
        in one process a broadcast view)."""
        D = v.shape[0] * self.world
        if D > 1:
            traffic.carry_bytes += _shard_bytes(v)
            traffic.n_collectives += math.ceil(math.log2(D))
        return self._from_rank(v[-1:], self.world - 1).expand_as(v)

    def send_next(self, x: torch.Tensor) -> torch.Tensor:
        """Each shard's value to the next shard, `[D, *s]` → `[D, *s]`,
        shard 0 receiving zeros (the pipeline's one-hop
        `ppermute(perm=[(0, 1)])` on two shards)."""
        out = torch.zeros_like(x)
        out[1:] = x[:-1]
        self._from_prev(x[-1], out[0])
        traffic.send_bytes += _shard_bytes(x)
        traffic.n_collectives += 1
        return out

    def _from_prev(self, last: torch.Tensor, first: torch.Tensor) -> None:
        """The previous rank's last shard into this rank's first: in one
        process there is none."""

    def _from_rank(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank src's `t` on every rank: in one process `t`."""
        return t

    # ---- state and output, not counted
    def replicate(self, tree, src: int = -1):
        """Rank `src`'s leaves of a (nested) tuple or NamedTuple of
        tensors on every rank, each rank passing its own of the same shapes: the
        stream state the last shard hands on. In one process the tree."""
        return tree

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block of t, concatenated along `dim` in rank
        order, on every rank: in one process t."""
        return t


class ProcessTransport(Transport):
    """The shards of `world` processes: this process's D_local shards on
    its tensor axis, the others' in theirs (see the module's docstring).
    `device` is where this process's tensors lie: a card (CUDA IPC) or the
    CPU (gloo). The default process group must be gloo
    (`ingest.initialize_distributed`'s default): an NCCL group holds one
    card a process, and across cards is not built."""

    def __init__(self, device):
        super().__init__()
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a transport across processes needs an "
                               "initialised torch.distributed group")
        if dist.get_backend() != "gloo":
            raise ValueError(
                f"a transport across processes runs over a gloo group, not "
                f"{dist.get_backend()}: NCCL puts each process on a card of "
                f"its own, and across cards is not built (ROADMAP queue 2)")
        self._dist = dist
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self._shared: dict = {}        # the peer buffers, kept by `using`

    def _slots(self):
        if "slots" not in self._shared:
            from supersdr_tpu_torch.ops.cuda import peer
            self._shared["slots"] = peer.PeerSlots(self.device, self.rank,
                                                   self.world)
        return self._shared["slots"]

    def _check(self, ts) -> None:
        for t in ts:
            if t.device.type != self.device.type:
                raise ValueError(f"a {self.device.type} transport was given"
                                 f" a tensor on {t.device}")

    def _send_recv(self, sends: dict, recvs: dict, section: int) -> None:
        """One exchange: sends[q] to rank q, recvs[q] (written in place)
        from rank q, in the same order and shapes on both sides; `section`
        bounds one sender's bytes to one receiver (the same on every
        rank). Every rank takes part, with or without tensors."""
        self._check([t for ts in (*sends.values(), *recvs.values())
                     for t in ts])
        if self.device.type == "cuda":
            self._slots().exchange(sends, recvs, section)
            return
        dist, reqs, keep, back = self._dist, [], [], []

        def real(t):
            return torch.view_as_real(t) if t.is_complex() else t
        for q, ts in recvs.items():
            for t in ts:
                buf = torch.empty(t.shape, dtype=t.dtype)
                reqs.append(dist.irecv(real(buf), src=q))
                back.append((t, buf))
        for q, ts in sends.items():
            for t in ts:
                keep.append(real(t.contiguous()))
                reqs.append(dist.isend(keep[-1], dst=q))
        for r in reqs:
            r.wait()
        for t, buf in back:
            t.copy_(buf)

    def _halo(self, x, n, fill, hop, head0, out):
        single = isinstance(x, torch.Tensor)
        xt = [x] if single else list(x)
        self._check(xt)
        d = xt[0].shape[-2]
        D, r = d * self.world, self.rank
        ot = [torch.empty(t.shape[:-1] + (n,), dtype=t.dtype,
                          device=t.device) for t in xt] if out is None \
            else ([out] if single else list(out))
        res = ot[0] if single else tuple(ot)
        head = head0 if r == 0 else None     # global shard 0 is rank 0's
        sends, recvs = _halo_routes(r, d, D, hop)
        fn = self._halo_fn()
        if self.device.type != "cuda":
            fn(x, n, fill, hop=hop, head0=head, out=res)
            self._send_recv(
                {q: [t[..., lo:hi, t.shape[-1] - n:] for t in xt]
                 for q, (lo, hi) in sends.items()},
                {q: [o[..., lo:hi, :] for o in ot]
                 for q, (lo, hi) in recvs.items()}, 0)
            return res
        # on the card: one launch writes this rank's halos and pushes its
        # tails into the right-hand ranks' receive buffers, which hold each
        # plane like `out` (its shape and strides) at aligned offsets
        slots = self._slots()
        spans = [_align(_span(o) * o.element_size()) for o in ot]
        slots.reserve(sum(spans))

        def like_out(box):
            views, off = [], 0
            for o, sp in zip(ot, spans):
                views.append(torch.as_strided(box[off:off + sp].view(o.dtype),
                                              o.shape, o.stride()))
                off += sp
            return views if not single else views[0]

        def push():
            # virtual shards d … of the kernel's table: shard v receives
            # the tail of this rank's shard v − hop, global r·d + v on rank
            # (r·d + v) // d; v < hop would be the stream's start (fill),
            # which no rank's halo takes from here: a scratch takes it
            peers, scratch = [], None
            for v in range(d, min(d + hop, D - r * d)):
                if v < hop:
                    if scratch is None:
                        scratch = like_out(torch.empty(
                            sum(spans), dtype=torch.uint8, device=self.device))
                    peers.append((scratch, 0))
                else:
                    q, s = divmod(r * d + v, d)
                    peers.append((like_out(slots.outbox(q)), s))
            fn(x, n, fill, hop=hop, head0=head, out=res, peers=peers)

        def pull():
            for q, (lo, hi) in recvs.items():
                views = like_out(slots.inbox(q))
                for o, vw in zip(ot, [views] if single else views):
                    o[..., lo:hi, :].copy_(vw[..., lo:hi, :])
        slots.round(list(sends), list(recvs), push, pull)
        return res

    def _a2a(self, y: torch.Tensor, ax: int) -> torch.Tensor:
        d, r = y.shape[0], self.rank
        full = torch.empty((d * self.world,) + y.shape[1:ax] + (d,)
                           + y.shape[ax + 1:], dtype=y.dtype, device=y.device)
        full[r * d:(r + 1) * d] = y.narrow(ax, r * d, d)
        others = [q for q in range(self.world) if q != r]
        piece = y.narrow(ax, 0, d)
        self._send_recv({q: [y.narrow(ax, q * d, d)] for q in others},
                        {q: [full[q * d:(q + 1) * d]] for q in others},
                        _align(_nbytes(piece)))
        return full

    def _from_prev(self, last: torch.Tensor, first: torch.Tensor) -> None:
        r = self.rank
        self._send_recv({r + 1: [last]} if r + 1 < self.world else {},
                        {r - 1: [first]} if r > 0 else {},
                        _align(_nbytes(last)))

    def _from_rank(self, t: torch.Tensor, src: int) -> torch.Tensor:
        src %= self.world
        if self.rank == src:
            self._send_recv({q: [t] for q in range(self.world) if q != src},
                            {}, _align(_nbytes(t)))
            return t
        got = torch.empty_like(t)
        self._send_recv({}, {src: [got]}, _align(_nbytes(t)))
        return got

    def replicate(self, tree, src: int = -1):
        leaves = held.leaves(tree)
        flat = torch.cat([v.contiguous().reshape(-1).view(torch.uint8)
                          for v in leaves])
        got = self._from_rank(flat, src)
        if got is flat:
            return tree
        out, off = [], 0
        for v in leaves:
            n = _nbytes(v)
            out.append(got[off:off + n].clone().view(v.dtype).view(v.shape))
            off += n
        return _refill(tree, iter(out))

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        others = [q for q in range(self.world) if q != self.rank]
        parts = {q: torch.empty_like(t) for q in others}
        self._send_recv({q: [t] for q in others},
                        {q: [parts[q]] for q in others}, _align(_nbytes(t)))
        parts[self.rank] = t
        return torch.cat([parts[q] for q in range(self.world)], dim=dim)


def _halo_routes(rank: int, d: int, D: int, hop: int):
    """For a shift of `hop` shards over `D // d` ranks of `d` shards: the
    ranges of this rank's shards whose tails go to each other rank
    (sends), and of its shards whose halos come from each other rank
    (recvs), as {rank: (lo, hi)} in this rank's local indices."""
    sends: dict = {}
    recvs: dict = {}
    for u in range(d):
        g = rank * d + u + hop
        if g < D and g // d != rank:
            sends.setdefault(g // d, [u, u])[1] = u + 1
        g = rank * d + u - hop
        if g >= 0 and g // d != rank:
            recvs.setdefault(g // d, [u, u])[1] = u + 1
    return ({q: tuple(v) for q, v in sends.items()},
            {q: tuple(v) for q, v in recvs.items()})


def for_processes(n_time: int, device: torch.device,
                  world: int | None = None) -> Transport:
    """The transport of a mesh of `n_time` time shards on `device`: one
    process (`Transport`) unless `torch.distributed` is initialised with
    more than one process; `world=1` asks for one process whatever the
    group, any other `world` must be the group's size. Processes split the
    time shards equally."""
    import torch.distributed as dist
    size = dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1
    world = size if world is None else world
    if world == 1:
        return Transport()
    if world != size:
        raise ValueError(f"world={world}, but the process group has {size}")
    if n_time % world:
        raise ValueError(f"{n_time} time shards do not split over {world} "
                         f"processes")
    return ProcessTransport(device)


LOCAL = Transport()


# ---- the one-process transport as functions, on tensors of every shard
def left_halo(x, n: int, fill: float = 0.0, *, head0=None,
              impl: str = "rdma"):
    """`Transport(impl).left_halo`: the last `n` samples of the left
    neighbour's block, `[*batch, D, n]`; shard 0 receives `fill`, or
    `head0` `[*batch, n]` when given."""
    return Transport(impl).left_halo(x, n, fill, head0=head0)


def left_context(x: torch.Tensor, n: int, fill: float = 0.0, *,
                 impl: str = "rdma") -> torch.Tensor:
    """`Transport(impl).left_context`."""
    return Transport(impl).left_context(x, n, fill)


def gather_summaries(s: torch.Tensor) -> torch.Tensor:
    return LOCAL.gather_summaries(s)


def shard_index(x: torch.Tensor) -> torch.Tensor:
    return LOCAL.shard_index(x)


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    return LOCAL.all_to_all(x, split_axis, concat_axis)


def broadcast_last(v: torch.Tensor) -> torch.Tensor:
    return LOCAL.broadcast_last(v)


def send_next(x: torch.Tensor) -> torch.Tensor:
    return LOCAL.send_next(x)
