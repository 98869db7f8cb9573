"""Device memory shared by the processes of a tensor-parallel group, and
the counters in it that streams wait on (``csrc/peer_memory.cu``).

K3's and K4's exchanges cross processes the way the TPU kernels cross
chips: a rank writes into, or reads from, its peers' memory.  Each rank
allocates a :class:`SharedRegion` with ``cudaMalloc`` (a block of
PyTorch's caching allocator is a sub-allocation, whose IPC handle names
its whole segment), exports it once by a CUDA IPC handle, and maps every
peer's from the handles gathered over the group's control group.  The
mapping works alike between cards (NVLink) and between contexts on one
card.

The TPU kernels' semaphores become 32-bit counters in that memory
(:class:`Flags`): :func:`write_flags` sets counters after a stream's
earlier work (``cuStreamWriteValue32``, whose default fence orders the
write after the stream's copies and kernels) and :func:`wait_flags` holds
a stream until counters reach a value (``cuStreamWaitValue32``, ``GEQ``),
so neither waits on the host.  On a device without stream memory
operations the first of them raises; nothing falls back.

:class:`PeerMemory` is what the kernels take: one rank's view of the
group (rank, size, device, control group) and the regions it has
exported, made at first use and kept by key.  Every region it makes is an
:class:`Exchange` (a payload, then a ready and a release counter per
rank): K3's depth-2 :class:`PeerRing` of step buffers and K4's
:class:`PeerShards`, one shard.  On the CPU there is no shared memory and
the kernels' plain versions gather over the control group instead
(:meth:`PeerMemory.all_gather`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.distributed as dist

from repro_torch.kernels import _build

# Sub-buffers of a region start on this boundary (TMA needs 16 bytes; the
# copy engines are fastest from 256).
ALIGN = 256
FLAG_BYTES = 4
# cudaErrorNotSupported and CUDA_ERROR_NOT_SUPPORTED (negated, as the CUDA
# sources return a driver error).
_NOT_SUPPORTED = (801, -801)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("peer_memory")
    ptr, u32, ll = ctypes.c_void_p, ctypes.c_uint, ctypes.c_longlong
    for name, args in {
        "peer_alloc": [ll, ctypes.POINTER(ptr), ptr],
        "peer_open": [ptr, ctypes.POINTER(ptr)],
        "peer_close": [ptr],
        "peer_free": [ptr],
        "peer_handle_bytes": [],
        "peer_flags_wait": [ptr, ctypes.c_int, u32, ptr],
        "peer_flags_write": [ptr, ctypes.c_int, u32, ptr],
        "peer_can_flush_remote_writes": [ctypes.POINTER(ctypes.c_int)],
    }.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


def check(err: int, lib: ctypes.CDLL | None = None,
          name: str = "peer_memory") -> None:
    """Raise if a C entry point of ``name``'s source (this module's by
    default) returned an error; a missing stream memory operation names
    the capability."""
    if err in _NOT_SUPPORTED:
        raise RuntimeError(
            "the CUDA device or driver lacks stream memory operations "
            "(cuStreamWaitValue32 / cuStreamWriteValue32), which order K3's "
            "and K4's exchange across processes; there is no other route")
    _build.check(lib or _lib(), name, err)


def aligned(nbytes: int) -> int:
    """``nbytes`` rounded up to :data:`ALIGN`."""
    return -(-nbytes // ALIGN) * ALIGN


class _DeviceMemory:
    """Raw device bytes as ``__cuda_array_interface__`` (version 2, which
    asks no stream synchronisation), for ``torch.as_tensor``; the tensor
    keeps this object, and so the region, alive."""

    def __init__(self, ptr: int, nbytes: int, owner):
        self.owner = owner
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2, "strides": None,
        }


class SharedRegion:
    """``nbytes`` of zeroed device memory on each rank of ``peers``, every
    rank's mapped into every other's.  Collective: every rank constructs
    it at the same point.  ``bases[r]`` is rank r's allocation as this
    process addresses it (its own, or the mapping of r's)."""

    def __init__(self, peers: PeerMemory, nbytes: int):
        if peers.device.type != "cuda":
            raise ValueError(f"a SharedRegion is device memory, not on "
                             f"{peers.device}")
        lib = _lib()
        self.device = peers.device
        self.rank = peers.rank
        self.nbytes = int(nbytes)
        own = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lib.peer_handle_bytes())
        check(lib.peer_alloc(self.nbytes, ctypes.byref(own), handle))
        self._own = own.value
        bases = []
        for r, raw in enumerate(peers.gather_object(handle.raw)):
            if r == self.rank:
                bases.append(self._own)
                continue
            peer = ctypes.c_void_p()
            check(lib.peer_open(raw, ctypes.byref(peer)))
            bases.append(peer.value)
        self.bases = tuple(bases)

    def view(self, offset: int, shape, dtype) -> torch.Tensor:
        """This rank's bytes at ``offset`` as a contiguous tensor."""
        n = torch.Size(shape).numel() * dtype.itemsize
        if offset < 0 or offset + n > self.nbytes:
            raise ValueError(f"{n} bytes at {offset} of a {self.nbytes}-byte "
                             "region")
        raw = torch.as_tensor(
            _DeviceMemory(self._own + offset, n, self), device=self.device)
        return raw.view(dtype).view(shape)

    def addresses(self, offset: int) -> list[int]:
        """Every rank's address of ``offset``, in rank order."""
        return [b + offset for b in self.bases]

    def unmap(self) -> None:
        """Close this process's mappings of its peers' memory."""
        lib = _lib()
        for r, base in enumerate(self.bases):
            if r != self.rank:
                check(lib.peer_close(base))
        self.bases = ()

    def free(self) -> None:
        """Free this rank's allocation (after every peer unmapped it)."""
        if self._own:
            check(_lib().peer_free(self._own))
            self._own = 0


class Flags:
    """``size`` 32-bit counters at ``offset`` of every rank's region:
    counter s in rank p's region belongs to the pair (p, s).  ``local`` are
    this rank's own counters, one per peer, which its streams wait on;
    ``remote`` is this rank's counter in every rank's region, which its
    streams write.  They take :func:`nbytes` bytes of each region."""

    def __init__(self, region: SharedRegion, offset: int, size: int):
        own = region.bases[region.rank]
        self.local = [own + offset + s * FLAG_BYTES for s in range(size)]
        self.remote = region.addresses(offset + region.rank * FLAG_BYTES)

    @staticmethod
    def nbytes(size: int) -> int:
        return aligned(size * FLAG_BYTES)


def _table(addresses) -> ctypes.Array:
    return (ctypes.c_void_p * len(addresses))(*addresses)


def wait_flags(addresses, value: int, stream) -> None:
    """``stream`` waits until every counter at ``addresses`` is at least
    ``value`` (cyclic 32-bit comparison)."""
    check(_lib().peer_flags_wait(_table(addresses), len(addresses),
                                 value & 0xFFFFFFFF, stream.cuda_stream))


def write_flags(addresses, value: int, stream) -> None:
    """Every counter at ``addresses`` is set to ``value`` once ``stream``'s
    earlier work is done."""
    check(_lib().peer_flags_write(_table(addresses), len(addresses),
                                  value & 0xFFFFFFFF, stream.cuda_stream))


def can_flush_remote_writes(device) -> bool:
    """``CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES`` of ``device``: whether
    its waits may carry ``CU_STREAM_WAIT_VALUE_FLUSH``.  The counters do
    not ask for it: a writer's counter is written after its copy on the
    same stream, with the write's default fence, and on four H100s joined
    by NVLink every reader saw the copy's bytes once it saw the counter
    (``chip_smoke.py [cards]`` (c))."""
    can = ctypes.c_int()
    with torch.cuda.device(device):
        check(_lib().peer_can_flush_remote_writes(ctypes.byref(can)))
    return bool(can.value)


class Exchange:
    """``payload`` bytes at offset 0 of a :class:`SharedRegion`, then a
    ready and a release counter per rank, at the same offsets on every
    rank.  ``ready`` (p, s) is rank p's counter for what s wrote into p's
    payload (or p's counter that s's shard is written); ``release`` (s, p)
    is rank s's counter for p's reads of what s wrote."""

    def __init__(self, peers: PeerMemory, payload: int):
        g = peers.size
        ready = aligned(payload)
        release = ready + Flags.nbytes(g)
        self.region = SharedRegion(peers, release + Flags.nbytes(g))
        self.ready = Flags(self.region, ready, g)
        self.release = Flags(self.region, release, g)

    def unmap(self) -> None:
        self.region.unmap()

    def free(self) -> None:
        self.region.free()


class PeerRing:
    """Rank r's ``depth`` step buffers for K3's chunk exchange across
    processes, for chunks of ``shape`` and ``dtype``: slots of (g,
    *shape), slot s of a buffer filled by rank s.

    On CUDA the slots and their counters are one :class:`Exchange`.  Step
    t (the t-th exchange through the ring, counted across calls) fills
    slot t % depth.  Its senders set this rank's ready counters to t + 1
    after their copies; :meth:`wait` holds a stream until all g reach it.
    After the step's GEMM, :meth:`release` sets this rank's counter in
    every sender's release counters to t + 1, and a sender's push of step
    t + depth waits for it before it overwrites the slot (``dst``,
    ``ready.remote`` and ``release.local`` are what the push takes).  On
    the CPU the slots are plain tensors, filled by the gloo all-gather,
    and the counters are not needed."""

    def __init__(self, peers: PeerMemory, shape, dtype, depth: int):
        self.peers = peers
        self.shape = tuple(shape)
        self.dtype = dtype
        self.depth = depth
        self.steps = 0  # exchanges pushed through the ring
        buf = (peers.size, *self.shape)
        if peers.device.type != "cuda":
            self.slots = [torch.empty(buf, dtype=dtype, device=peers.device)
                          for _ in range(depth)]
            self.mem = None
            return
        slot_bytes = aligned(math.prod(buf) * dtype.itemsize)
        self.mem = Exchange(peers, depth * slot_bytes)
        self.slots = [self.mem.region.view(i * slot_bytes, buf, dtype)
                      for i in range(depth)]
        # Where this rank's chunk lands in rank p's buffer i: slot `me`.
        own_slot = peers.rank * math.prod(self.shape) * dtype.itemsize
        self.dst = [self.mem.region.addresses(i * slot_bytes + own_slot)
                    for i in range(depth)]

    def slot(self, step: int) -> torch.Tensor:
        """The (g, *shape) step buffer that step ``step`` fills."""
        return self.slots[step % self.depth]

    def wait(self, step: int, stream) -> None:
        """``stream`` waits until every sender's chunk of ``step`` landed."""
        if self.mem is not None:
            wait_flags(self.mem.ready.local, step + 1, stream)

    def release(self, step: int, stream) -> None:
        """Once ``stream``'s work so far is done, tell every sender that
        ``step``'s slot has been read."""
        if self.mem is not None:
            write_flags(self.mem.release.remote, step + 1, stream)

    def unmap(self) -> None:
        if self.mem is not None:
            self.mem.unmap()

    def free(self) -> None:
        self.slots = []
        if self.mem is not None:
            self.mem.free()


class PeerShards:
    """Rank r's exported (m_s, K) shard for K4 across processes and its
    counters (one :class:`Exchange`).  Call t (counted across calls):
    :meth:`put` waits until every peer's release counter for this rank
    reaches t (their call t - 1 has read this shard), copies x into the
    shard, sets its ready counter in every rank's memory to t + 1 and waits
    for every rank's ready counter in its own to reach t + 1; the caller
    launches over ``addresses``; :meth:`done` sets its release counter in
    every rank's memory to t + 1.  All on the given stream, none on the
    host."""

    def __init__(self, peers: PeerMemory, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.calls = 0
        self.mem = Exchange(peers, math.prod(self.shape) * dtype.itemsize)
        self.shard = self.mem.region.view(0, self.shape, dtype)
        self.addresses = self.mem.region.addresses(0)

    def put(self, x: torch.Tensor, stream) -> int:
        """Call t's shard in place on every rank, in ``stream`` order;
        returns t."""
        t, self.calls = self.calls, self.calls + 1
        if t:
            wait_flags(self.mem.release.local, t, stream)
        with torch.cuda.stream(stream):
            self.shard.copy_(x)
        write_flags(self.mem.ready.remote, t + 1, stream)
        wait_flags(self.mem.ready.local, t + 1, stream)
        return t

    def done(self, t: int, stream) -> None:
        """Once ``stream``'s launch of call t is done, tell every rank that
        this rank has read their shards."""
        write_flags(self.mem.release.remote, t + 1, stream)

    def unmap(self) -> None:
        self.mem.unmap()

    def free(self) -> None:
        self.shard = None
        self.mem.free()


class PeerMemory:
    """One rank's part of a group of ``size`` processes, as K3 and K4 see
    it: ``rank``, ``device``, the gloo ``control`` process group (handle
    exchange, barriers, and the plain versions' all-gather on the CPU) and
    the regions exported so far.  :meth:`ring` and :meth:`shards` are
    collective at first use of a key: every rank asks for it at the same
    point, since making it exchanges handles.  :meth:`close` unmaps the
    peers' memory, waits for every rank, and frees its own."""

    def __init__(self, rank: int, size: int, device: torch.device, control):
        self.rank, self.size = rank, size
        self.device = device
        self.control = control
        self._held: dict = {}

    def gather_object(self, obj) -> list:
        """Every rank's ``obj``, in rank order, over the control group."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.control)
        return out

    def all_gather(self, x: torch.Tensor, out: torch.Tensor) -> None:
        """``out`` (g, *x.shape) <- every rank's ``x``, over the control
        group: the plain version of the exchange on the CPU."""
        dist.all_gather_into_tensor(out.flatten(0, 1), x.contiguous(),
                                    group=self.control)

    def _get(self, key, make):
        if key not in self._held:
            self._held[key] = make()
        return self._held[key]

    def ring(self, shape, dtype, depth: int) -> PeerRing:
        """The :class:`PeerRing` for chunks of ``shape`` and ``dtype``."""
        return self._get(("ring", tuple(shape), dtype, depth),
                         lambda: PeerRing(self, shape, dtype, depth))

    def shards(self, shape, dtype) -> PeerShards:
        """The :class:`PeerShards` for shards of ``shape`` and ``dtype``."""
        return self._get(("shards", tuple(shape), dtype),
                         lambda: PeerShards(self, shape, dtype))

    def close(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        held, self._held = list(self._held.values()), {}
        for h in held:
            h.unmap()
        dist.barrier(group=self.control)
        for h in held:
            h.free()


__all__ = ["ALIGN", "FLAG_BYTES", "aligned", "check", "SharedRegion",
           "Flags", "wait_flags", "write_flags", "can_flush_remote_writes",
           "Exchange", "PeerRing", "PeerShards", "PeerMemory"]
