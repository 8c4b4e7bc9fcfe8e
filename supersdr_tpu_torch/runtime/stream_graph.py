"""One stream's planar chunk replayed as a held CUDA graph.

On the planar tier a chunk is a short sequence of launches: the
channelizer, the history's permute and cast, the state rows' gathers by
the planar order, the FIR tail, the RSSI's dB, the unpack. At a live
monitor's 512 frames the card runs them in a few tenths of a millisecond
and the host takes several times that to issue them. `GraphRunner`
records the sequence once for a stream (`torch.cuda.CUDAGraph`) and
replays it each chunk: the same kernels in the same order on the same
values, so its outputs are the eager chunk's bit for bit.

A graph reads and writes fixed addresses, so the runner holds, for its
stream: two int16 input planes of `chunk_in` samples, into which each
chunk's wire planes are copied (`non_blocking`: from pinned memory the
host goes on at once, so the caller leaves a pinned buffer as it is until
the chunk's results are fetched); the stream state's leaves, into which
the graph copies the new state at its end; the audio and RSSI the graph
writes; and every tensor made before the recording that the recorded
chunk read (the parameters, the plan's row orders, the tables the
kernels read), so that no cache dropping its entry frees memory the graph
reads. The state it returns is a `WidebandState` over its leaves; that
state, the audio and the RSSI stay valid until the next call. A call given
that state object again replays at once; any other state (a stream's
first chunk, a restored checkpoint, a state made by hand) is copied into
the leaves first.

It replays only where it can see that the graph is the eager chunk:
`wrap` builds a runner only on a CUDA device for a configuration that
`wideband.process` runs on the planar tier (the tier depends on nothing
else, so a chunk does not look it up again), and a call replays only a
chunk that is the wire's (re_i16, im_i16) pair (`wideband.is_i16_pair`) of
`chunk_in` samples each, with the parameters object it was recorded with,
whose tensors keep the versions seen then (the rule of
`utils/held.FromTensors`). A new parameters object, or one written in
place, is recorded anew before the chunk runs; any other chunk (complex
input) runs the eager process function. The graph reuses its buffers, so
`wideband.process` itself stays as it is: a functional caller
(`process_n` keeps every chunk's audio) never sees them.

Recording runs the chunk once eagerly first, on a side stream and on the
held planes and leaves (zeros and a copy of the stream's first state when
the runner is built), which builds every table and tile the chunk holds
and loads every kernel; the leaves are then set back. A replay
does not run the kernels' Python wrappers, so the recording notes how far
each counted wrapper (`ops/cuda.counted`) grew while it ran, puts the
counts back (a recording launches nothing), and each replay adds those
launches; an eager chunk's wrappers count themselves. So a replay counts
what its recording launched, not what it ran; a trace of the replays
checks the two agree (`chip_smoke.py`'s `graph` and `monitor` phases).

Under a running `torch.profiler` a replayed chunk records the spans
`wideband.feed` (issuing the two copies from pinned memory or the card,
which the host does not wait for; from pageable host memory the host
waits, so the span is the crossing `wideband.ingest` and each such plane
is counted by `profiling.count_sync`) and `wideband.replay` (`replay()`),
and every call records `profiling.count_graph`: whether it replayed a held
graph. A replayed chunk looks up no plan, so it records no
`profiling.count_plan`.
"""

from __future__ import annotations

import weakref

import torch
from torch.overrides import TorchFunctionMode

from supersdr_tpu_torch.ops import cuda as cuda_ops
from supersdr_tpu_torch.runtime import wideband
from supersdr_tpu_torch.utils import held, profiling


def _clone(tree):
    """The tree of named tuples with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(None if v is None else _clone(v) for v in tree))


def _copy_into(leaves: list, tree) -> None:
    """Copy the tensors of `tree` into `leaves`, each onto its own."""
    for dst, src in zip(leaves, held.leaves(tree), strict=True):
        if src is not dst:
            dst.copy_(src)


class _Reads(TorchFunctionMode):
    """Every tensor a block hands to a torch function or tensor method
    that no call inside the block made: what the block read of the world
    before it."""

    def __init__(self):
        super().__init__()
        self.made = weakref.WeakValueDictionary()
        self.read: dict = {}

    def _note(self, value, into) -> None:
        if isinstance(value, torch.Tensor):
            into(value)
        elif isinstance(value, (tuple, list)):
            for v in value:
                self._note(v, into)
        elif isinstance(value, dict):
            for v in value.values():
                self._note(v, into)

    def _read(self, t: torch.Tensor) -> None:
        if self.made.get(id(t)) is not t:
            self.read[id(t)] = t

    def _made(self, t: torch.Tensor) -> None:
        self.made[id(t)] = t

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._note((args, kwargs), self._read)
        out = func(*args, **kwargs)
        self._note(out, self._made)
        return out


class CudaGraph:
    """`torch.cuda.CUDAGraph` behind the runner's three calls."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()

    @staticmethod
    def records_on(device: torch.device) -> bool:
        return device.type == "cuda"

    def warm(self, body) -> None:
        """Run `body` on a side stream, after the current stream's work,
        and have the current stream wait for it."""
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                body()
            main.wait_stream(side)

    def capture(self, body):
        """Record `body`; returns what it returned."""
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
            return body()

    def replay(self) -> None:
        self.graph.replay()


class GraphRunner:
    """The monitor's process function `(params, state, iq) -> (state,
    audio, rssi)` on a graph held for one stream (the module's
    docstring); `eager` is the same function without one, and `graph` the
    class of the graph (`CudaGraph`)."""

    def __init__(self, cfg: wideband.WidebandConfig,
                 params: wideband.WidebandParams,
                 state: wideband.WidebandState, eager, graph=CudaGraph):
        self.cfg, self.eager, self._graph_type = cfg, eager, graph
        self.device = params.W_pfb.device
        self._wrappers = cuda_ops.counted()
        self._planes = tuple(torch.zeros(cfg.chunk_in, dtype=torch.int16,
                                         device=self.device)
                             for _ in range(2))
        self.state = _clone(state)
        self._leaves = held.leaves(self.state)
        self._record(params)

    def _chunk(self, params: wideband.WidebandParams) -> tuple:
        """One eager chunk on the held planes and leaves; the new state
        copied into the leaves. Returns (audio, rssi)."""
        st, out = wideband.process(self.cfg, params, self.state,
                                   self._planes)
        _copy_into(self._leaves, st)
        return out.audio, out.rssi

    def _record(self, params: wideband.WidebandParams) -> None:
        """Run the chunk once and record it for `params`; the leaves are
        left as the run found them."""
        graph = self._graph_type(self.device)
        before = _clone(self.state)
        graph.warm(lambda: self._chunk(params))
        counts = {n: w.launches for n, w in self._wrappers.items()}
        reads = _Reads()

        def body():
            with reads:
                return self._chunk(params)
        out = graph.capture(body)
        self._launched = [(w, w.launches - counts[n])
                          for n, w in self._wrappers.items()
                          if w.launches != counts[n]]
        for n, w in self._wrappers.items():
            w.launches = counts[n]
        _copy_into(self._leaves, before)
        self._graph, self._out, self._reads = graph, out, reads.read
        self._params, self._sources = params, held.leaves(params)
        self._versions = held.versions(self._sources)

    def _wire(self, iq) -> bool:
        """True for an (re_i16, im_i16) pair of `chunk_in` samples each."""
        return wideband.is_i16_pair(iq) and all(
            tuple(p.shape) == (self.cfg.chunk_in,) for p in iq)

    def _eager(self, params, state, iq):
        profiling.count_graph(False)
        return self.eager(params, state, iq)

    def __call__(self, params, state, iq):
        if not self._wire(iq):
            return self._eager(params, state, iq)
        replayed = (params is self._params
                    and held.versions(self._sources) == self._versions)
        if not replayed:
            if held.versions(held.leaves(params)) is None:
                return self._eager(params, state, iq)
            self._record(params)
        if state is not self.state:
            _copy_into(self._leaves, state)
        srcs = [torch.as_tensor(p) for p in iq]
        waits = profiling.recording() and sum(
            p.device.type == "cpu" and not p.is_pinned() for p in srcs)
        for _ in range(waits):
            profiling.count_sync()
        with profiling.span("wideband.ingest" if waits else "wideband.feed"):
            for dst, src in zip(self._planes, srcs):
                dst.copy_(src, non_blocking=True)
        with profiling.span("wideband.replay"):
            self._graph.replay()
        for w, n in self._launched:
            w.launches += n
        profiling.count_graph(replayed)
        return (self.state, *self._out)


def wrap(cfg: wideband.WidebandConfig, params: wideband.WidebandParams,
         state: wideband.WidebandState, eager, graph=CudaGraph):
    """A `GraphRunner` over `eager` where one can serve the stream: on a
    device `graph` records on (`CudaGraph`: a CUDA device), for a
    configuration `wideband.process` runs on the planar tier, with
    parameters whose tensors have versions. Elsewhere `eager` itself."""
    if not (graph.records_on(params.W_pfb.device)
            and wideband.tier_facts(cfg).planar
            and held.versions(held.leaves(params)) is not None):
        return eager
    return GraphRunner(cfg, params, state, eager, graph)
