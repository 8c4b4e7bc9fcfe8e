"""Receive buffers shared between processes on CUDA devices, and the
ordering that makes a push into them safe.

What `parallel/collectives.ProcessTransport` moves between processes whose
tensors lie on a card goes through here. Every process owns one receive
buffer, allocated by the kernel library with `cudaMalloc` (an IPC handle
then names exactly the buffer, at offset 0, where a pointer into PyTorch's
caching allocator would name the whole pool block; and the allocator's
`expandable_segments` setting, under which its blocks cannot be opened with
`cudaIpcOpenMemHandle`, does not apply), and mapped into every other
process with CUDA IPC (`cudaIpcGetMemHandle` / `cudaIpcOpenMemHandle`; a
process never opens its own handle). The buffer holds two slots, used by
call parity, each cut into one section per sending process, so sender q
writes receiver r's slot at section q and two senders never overlap.

One exchange is a round, on the current stream of every process:

  1. wait on each receiver's IPC event "read_done" of this parity (its read
     of this slot two rounds ago);
  2. push: the halo kernel's peer destinations or `copy_` into the mapped
     sections;
  3. record this process's IPC event "pushed" of this parity;
  4. meet the other processes on the host (a barrier of the gloo group):
     after it every sender's record of step 3 has been made;
  5. wait on each sender's "pushed" of this parity, then read this slot;
  6. record "read_done" of this parity.

`cudaStreamWaitEvent` on an event not yet recorded returns at once, so each
wait in steps 1 and 5 is enqueued only after the host knows that the record
it waits on was made: step 1's record was made before the previous round's
barrier, step 5's before this round's; and neither event is recorded again
before the wait, since that needs the next barrier. No kernel spins on a
flag: without MPS the kernels of two processes time-slice on one card, and
a spin would hold the card from the process it waits for.

The buffer grows when a round needs more (every process computes the same
size from shapes that are the same on every rank, so all grow in the same
round): each process synchronises, meets the others, closes its mappings,
meets them again (so no peer still maps its old buffer), frees its own,
allocates and exchanges handles anew. A process leaves only after its
card is idle and it has met the others (`parallel/launch.py`), so no peer
still writes a buffer that its exit frees. The data never leaves the card;
the host exchanges only the handles and the barrier of each round.

Everything here raises where it cannot map a peer, and where the
processes do not all use the same card (their card UUIDs are compared
first: across cards is not built); nothing falls back to host copies.
"""

from __future__ import annotations

import ctypes

import torch

from supersdr_tpu_torch import _build

SLOTS = 2                  # call parity
ALIGN = 256                # bytes: every region of a section starts aligned
MIN_SECTION = 1 << 20


def align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


class _DeviceBytes:
    """A device allocation as `__cuda_array_interface__`, for a uint8
    tensor over it (PyTorch keeps this object alive with the tensor)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


def _card_id(device: torch.device) -> str:
    """The card's UUID, the same in every process that uses it."""
    return str(torch.cuda.get_device_properties(device).uuid)


def check_one_card(ids: list) -> None:
    """Raise unless every process's card id in `ids` is the same: the
    buffers are mapped between processes of one card; across cards
    (NVLink peer pointers) is not built (ROADMAP queue 2)."""
    if len(set(ids)) > 1:
        raise ValueError(
            f"the processes use {len(set(ids))} cards ({sorted(set(ids))}): "
            f"peer buffers are built between processes of one card; across "
            f"cards is not built (ROADMAP queue 2)")


class PeerSlots:
    """This process's receive buffer, every peer's mapped into it, and the
    IPC events of the rounds (see the module's docstring), over the
    default process group (gloo) of `world` processes, `rank` this one.
    Every process must use the same card."""

    def __init__(self, device: torch.device, rank: int, world: int):
        if device.type != "cuda":
            raise ValueError(f"peer buffers live on a card, not {device}")
        import torch.distributed as dist
        ids = [None] * world
        dist.all_gather_object(ids, _card_id(device))
        check_one_card(ids)
        self._dist = dist
        self.device = device
        self.rank, self.world = rank, world
        self.rounds = 0
        self.section = 0
        self._own = None                 # (pointer, uint8 tensor)
        self._peers: dict = {}           # rank -> (pointer, uint8 tensor)
        self._lib = _build.load()
        # pushed[p], read_done[p]: this process's events of parity p;
        # every peer's opened from their IPC handles
        mine = {k: [torch.cuda.Event(interprocess=True)
                    for _ in range(SLOTS)] for k in ("pushed", "read_done")}
        with torch.cuda.device(device):
            handles = {k: [e.ipc_handle() for e in v]
                       for k, v in mine.items()}
        got = [None] * world
        dist.all_gather_object(got, handles)
        self.events = {}
        for q in range(world):
            if q == rank:
                self.events[q] = mine
            else:
                self.events[q] = {
                    k: [torch.cuda.Event.from_ipc_handle(device, h)
                        for h in v] for k, v in got[q].items()}

    # ---- buffers
    def _bytes(self, ptr: int, nbytes: int) -> torch.Tensor:
        return torch.as_tensor(_DeviceBytes(ptr, nbytes), device=self.device)

    def _map(self, section: int) -> None:
        """Allocate this process's buffer of `section` bytes a section and
        open every peer's (collective)."""
        lib, dev = self._lib, self.device.index
        nbytes = SLOTS * self.world * section
        ptr = ctypes.c_void_p()
        _build.check(lib.peer_alloc(dev, nbytes, ctypes.byref(ptr)),
                     "peer_alloc")
        self._own = (ptr.value, self._bytes(ptr.value, nbytes))
        handle = ctypes.create_string_buffer(lib.peer_handle_bytes())
        _build.check(lib.peer_ipc_handle(dev, ctypes.c_void_p(ptr.value),
                                         handle), "peer_ipc_handle")
        got = [None] * self.world
        self._dist.all_gather_object(got, handle.raw)
        for q in range(self.world):
            if q == self.rank:
                continue
            peer = ctypes.c_void_p()
            _build.check(lib.peer_ipc_open(dev, ctypes.create_string_buffer(
                got[q], len(got[q])), ctypes.byref(peer)), "peer_ipc_open")
            self._peers[q] = (peer.value, self._bytes(peer.value, nbytes))
        self.section = section

    def _unmap(self) -> None:
        """Close every mapping, then free this process's buffer once no
        peer maps it any more (collective)."""
        lib, dev = self._lib, self.device.index
        torch.cuda.synchronize(self.device)
        self._dist.barrier()
        for ptr, _ in self._peers.values():
            _build.check(lib.peer_ipc_close(dev, ctypes.c_void_p(ptr)),
                         "peer_ipc_close")
        self._peers.clear()
        self._dist.barrier()
        if self._own is not None:
            _build.check(lib.peer_free(dev, ctypes.c_void_p(self._own[0])),
                         "peer_free")
        self._own = None
        self.section = 0

    def reserve(self, section: int) -> None:
        """At least `section` bytes a section (collective: every process
        asks for the same size in the same round)."""
        if section <= self.section:
            return
        section = max(align(section), 2 * self.section, MIN_SECTION)
        if self._own is not None:
            self._unmap()
        self._map(section)

    def _region(self, buf: torch.Tensor, sender: int) -> torch.Tensor:
        p = self.rounds % SLOTS
        start = (p * self.world + sender) * self.section
        return buf[start:start + self.section]

    def outbox(self, q: int) -> torch.Tensor:
        """This round's section of receiver q's slot that this process
        writes, uint8, mapped from q."""
        return self._region(self._peers[q][1], self.rank)

    def inbox(self, q: int) -> torch.Tensor:
        """This round's section of this process's slot that sender q
        writes."""
        return self._region(self._own[1], q)

    # ---- one round
    def round(self, dsts, srcs, push, pull) -> None:
        """Steps 1-6 of the module's docstring: push() writes the
        outboxes of `dsts`, pull() reads the inboxes of `srcs`."""
        p = self.rounds % SLOTS
        st = torch.cuda.current_stream(self.device)
        for q in dsts:
            st.wait_event(self.events[q]["read_done"][p])
        push()
        self.events[self.rank]["pushed"][p].record(st)
        self._dist.barrier()
        for q in srcs:
            st.wait_event(self.events[q]["pushed"][p])
        pull()
        self.events[self.rank]["read_done"][p].record(st)
        self.rounds += 1

    def exchange(self, sends: dict, recvs: dict, section: int) -> None:
        """Tensors to other processes and back in one round: sends[q] are
        this process's tensors for q, recvs[q] the tensors (written in
        place, any strides) that take q's, in the same order and shapes;
        `section` bounds the bytes one sender writes one receiver, the same
        number on every process."""
        self.reserve(section)

        def push():
            for q, ts in sends.items():
                box, off = self.outbox(q), 0
                for t in ts:
                    n = t.numel() * t.element_size()
                    box[off:off + n].view(t.dtype).view(t.shape).copy_(t)
                    off = align(off + n)

        def pull():
            for q, ts in recvs.items():
                box, off = self.inbox(q), 0
                for t in ts:
                    n = t.numel() * t.element_size()
                    t.copy_(box[off:off + n].view(t.dtype).view(t.shape))
                    off = align(off + n)
        self.round(list(sends), list(recvs), push, pull)
