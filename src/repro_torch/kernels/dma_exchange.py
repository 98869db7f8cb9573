"""K3: the FiCCO chunk exchange on the copy engines, and its composer.

Port of ``repro.kernels.dma_exchange``.  :func:`a2a_chunk_exchange` is one
FiCCO step's all-to-all: on CUDA tensors it calls ``csrc/dma_exchange.cu``,
which issues device-to-device copies, so the copy engines move the bytes
and no SM does (the paper's ``hipMemcpyDtoDAsync`` offload).  On CPU
tensors it takes the plain version
:func:`repro_torch.kernels.ref.a2a_chunk_exchange_ref`.

The wrapper picks the route by :func:`route`, from the operands alone, and
the C side launches it or refuses the operands; nothing falls back.
``"strided"``: the senders' chunks are one tensor and the step buffers
another, so each receiver's g slots are filled by one 2D copy (g copies a
step).  ``"pairs"``: one copy per (sender, slot) through pointer tables,
for chunks or step buffers given as one tensor per rank, as peer-mapped
buffers across cards would be.  ``a2a_chunk_exchange.routes`` counts the
calls of each route.

Across processes (a group whose ranks are processes, seen through its
:class:`~repro_torch.kernels.peer_memory.PeerMemory`), one call is rank
r's half of the reference's kernel, on the ``pairs`` route: its chunk into
slot r of every rank's step buffer, a local copy and g - 1 pushes, into a
:class:`~repro_torch.kernels.peer_memory.PeerRing` (exported step buffers
whose ready and release counters take the place of the TPU kernel's send
and receive semaphores; see ``csrc/dma_exchange.cu``).  On the CPU its
plain version is the gloo all-gather of the chunk into the step buffer.

:func:`ficco_uniform_fused_1d_dma` composes the exchange with the step GEMM
(K1) into uniform-fused-1D.  On the TPU, XLA's scheduler overlapped step
s+1's DMAs with step s's matmul; here the overlap is written out: the
exchange runs on the group's copy streams, the GEMMs on the compute
stream, and CUDA events order them around two step buffers; across
processes the ring's counters order them, with no host wait per step or
per call.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections.abc import Sequence

import torch

from repro_torch.kernels import _build, peer_memory
from repro_torch.kernels.chunked_gemm import chunked_matmul, refuse_grad
from repro_torch.kernels.peer_memory import PeerMemory, PeerRing
from repro_torch.kernels.ref import a2a_chunk_exchange_ref
from repro_torch.tune.registry import resolve_variant

# Step buffers the pipeline rotates through: step s+1's exchange fills one
# while step s's GEMM reads the other.
STEP_BUFFERS = 2
ROUTES = ("strided", "pairs")
MAX_STREAMS = 16  # MAX_STREAMS in the CUDA source


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dma_exchange")
    lib.dma_exchange_strided.restype = ctypes.c_int
    lib.dma_exchange_strided.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.dma_exchange_pairs.restype = ctypes.c_int
    lib.dma_exchange_pairs.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.dma_exchange_push.restype = ctypes.c_int
    lib.dma_exchange_push.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
        ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.dma_copy_engines.restype = ctypes.c_int
    lib.dma_copy_engines.argtypes = [ctypes.POINTER(ctypes.c_int)]
    return lib


def copy_engines() -> int:
    """The current CUDA device's copy-engine count
    (``cudaDevAttrAsyncEngineCount``)."""
    lib = _lib()
    n = ctypes.c_int()
    _build.check(lib, "dma_exchange", lib.dma_copy_engines(ctypes.byref(n)))
    return n.value


def _inner_contiguous(t: torch.Tensor, lead: int) -> bool:
    """Whether every t[i_0, ..., i_{lead-1}] is one contiguous block."""
    expected = 1
    for size, stride in zip(reversed(t.shape[lead:]),
                            reversed(t.stride()[lead:])):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def _strided(chunks, out):
    """(width, source pitch, destination rank stride, destination pitch)
    in bytes of the strided route, or None when it does not take the
    operands: they must be one tensor of chunks and one of step buffers,
    with the senders' chunks and each receiver's slots at a stride no
    smaller than a chunk (what a 2D copy's pitches must be).  A size-1
    rank dim takes the chunk width as its pitch."""
    if not (isinstance(chunks, torch.Tensor)
            and isinstance(out, torch.Tensor)):
        return None
    esize = chunks.element_size()
    width = math.prod(chunks.shape[1:]) * esize
    g = chunks.shape[0]
    spitch = chunks.stride(0) * esize if g > 1 else width
    dpitch = out.stride(1) * esize if g > 1 else width
    if spitch < width or dpitch < width:
        return None
    return width, spitch, out.stride(0) * esize, dpitch


def route(chunks, out) -> str:
    """The route a CUDA call of ``a2a_chunk_exchange(chunks, out=out)``
    takes: ``"strided"`` when one 2D copy per receiver can do the exchange
    (see :func:`_strided`); ``"pairs"`` for one tensor per rank, or
    strides a 2D copy cannot take (a broadcast chunk, overlapping slots).
    """
    return "pairs" if _strided(chunks, out) is None else "strided"


def strided_plan(chunks: torch.Tensor, out: torch.Tensor,
                 reverse: bool = False):
    """The strided route's copies, in issue order, as ``dma_exchange.cu``
    computes them: per receiver r, (source offset, source pitch,
    destination offset, destination pitch, width, height) in bytes from
    ``chunks``'s and ``out``'s first elements."""
    g = chunks.shape[0]
    width, spitch, drank, dpitch = _strided(chunks, out)
    order = [(g - j) % g if reverse else j for j in range(g)]
    return [(0, spitch, r * drank, dpitch, width, g) for r in order]


def _per_rank(t, lead: int) -> list[torch.Tensor]:
    """t's rank blocks, raising unless every block's sub-blocks below
    ``lead`` dims are contiguous."""
    ranks = list(t)
    for blk in ranks:
        if not _inner_contiguous(blk, lead):
            raise ValueError("a2a_chunk_exchange needs each rank's chunk and "
                             "each step-buffer slot contiguous")
    return ranks


@functools.lru_cache(maxsize=64)
def _stream_table(handles: tuple[int, ...]):
    return (ctypes.c_void_p * len(handles))(*handles)


def _stream_handles(device, streams) -> tuple[int, ...]:
    """The current stream's and ``streams``' handles, the current first."""
    handles = tuple(s.cuda_stream for s in
                    (torch.cuda.current_stream(device), *streams))
    if len(handles) > MAX_STREAMS:
        raise ValueError(f"{len(handles)} streams; the exchange takes up to "
                         f"{MAX_STREAMS}")
    return handles


def _launch(chunks, out, reverse: bool, streams, device) -> None:
    g = len(chunks)
    handles = _stream_handles(device, streams)
    table = _stream_table(handles)
    strided = _strided(chunks, out)
    name = "pairs" if strided is None else "strided"
    lib = _lib()
    if strided is not None:
        if not (_inner_contiguous(chunks, 1) and _inner_contiguous(out, 2)):
            raise ValueError("a2a_chunk_exchange needs each rank's chunk and "
                             "each step-buffer slot contiguous")
        width, spitch, drank, dpitch = strided
        err = lib.dma_exchange_strided(
            chunks.data_ptr(), spitch, out.data_ptr(), drank, dpitch, width,
            g, int(reverse), table, len(handles),
        )
    else:
        srcs = _per_rank(chunks, 0)
        dsts = _per_rank(out, 1)
        esize = srcs[0].element_size()
        src = (ctypes.c_void_p * g)(*[c.data_ptr() for c in srcs])
        dst = (ctypes.c_void_p * (g * g))(*[
            b.data_ptr() + s * b.stride(0) * esize
            for b in dsts for s in range(g)
        ])
        err = lib.dma_exchange_pairs(
            src, dst, srcs[0].numel() * esize, g, int(reverse), table,
            len(handles),
        )
    _build.check(lib, "dma_exchange", err)
    a2a_chunk_exchange.launches += 1
    a2a_chunk_exchange.routes[name] += 1


def _push(chunk: torch.Tensor, ring: PeerRing, reverse: bool,
          streams) -> int:
    """Rank r's half of the ring's next step: the ``pairs`` route across
    processes (CUDA), or the gloo all-gather (CPU).  Returns the step."""
    step, ring.steps = ring.steps, ring.steps + 1
    out = ring.slot(step)
    if ring.mem is None:
        ring.peers.all_gather(chunk, out)
        return step
    if not streams:
        raise ValueError("on CUDA the exchange needs a copy stream")
    if not chunk.is_contiguous():
        raise ValueError("a2a_chunk_exchange needs this rank's chunk "
                         "contiguous")
    handles = _stream_handles(chunk.device, streams)
    g, depth = ring.peers.size, ring.depth
    table = (ctypes.c_void_p * g)
    lib = _lib()
    err = lib.dma_exchange_push(
        chunk.data_ptr(), table(*ring.dst[step % depth]),
        chunk.numel() * chunk.element_size(), g, ring.peers.rank,
        int(reverse), table(*ring.mem.ready.remote), (step + 1) & 0xFFFFFFFF,
        table(*ring.mem.release.local),
        (step - depth + 1) & 0xFFFFFFFF if step >= depth else 0,
        _stream_table(handles), len(handles),
    )
    peer_memory.check(err, lib, "dma_exchange")
    a2a_chunk_exchange.launches += 1
    a2a_chunk_exchange.routes["pairs"] += 1
    return step


def a2a_chunk_exchange(
    chunks,
    *,
    reverse: bool = False,
    out=None,
    streams: Sequence = (),
):
    """One FiCCO exchange step: (g, m_c, K) chunks -> (g, g, m_c, K).

    ``chunks[r]`` is rank r's chunk; ``out[r, s]`` is slot s of rank r's
    step buffer and receives rank s's chunk, so every rank ends with the
    same gathered buffer (``all_gather(axis=0)``).  Either may also be a
    sequence of g per-rank tensors ((m_c, K) chunks, (g, m_c, K) buffers),
    as buffers that live in separate allocations are; ``out`` is then
    returned as given.  ``reverse`` issues the copies to peers in
    descending offset order; the result is unchanged.  On CUDA the copies
    are enqueued on the current stream, spread by receiver over it and
    ``streams`` (each forked from the current stream and joined back).

    With ``out`` a :class:`~repro_torch.kernels.peer_memory.PeerRing` (a
    group whose ranks are processes),
    ``chunks`` is this rank's chunk of the ring's shape and dtype, and the
    call pushes it as the ring's next step, returning the step's number:
    ``out.slot(step)`` is this rank's step buffer, which a stream may read
    after ``out.wait(step, stream)`` and must hand back with
    ``out.release(step, stream)``.
    """
    if isinstance(out, PeerRing):
        if (tuple(chunks.shape) != out.shape or chunks.dtype != out.dtype
                or chunks.device != out.peers.device):
            raise ValueError(
                f"a chunk of {tuple(chunks.shape)} {chunks.dtype} on "
                f"{chunks.device} for a ring of {out.shape} {out.dtype} on "
                f"{out.peers.device}")
        return _push(chunks, out, reverse, streams)
    g = len(chunks)
    one = chunks if isinstance(chunks, torch.Tensor) else chunks[0]
    shape = tuple(chunks.shape[1:]) if one is chunks else tuple(one.shape)
    dtype, device = one.dtype, one.device
    if out is None:
        out = torch.empty((g, g, *shape), dtype=dtype, device=device)
    # One tensor is checked whole; per-rank tensors one by one.
    if isinstance(chunks, torch.Tensor):
        pieces = [(chunks, (g, *shape))]
    else:
        pieces = [(t, shape) for t in chunks]
    if isinstance(out, torch.Tensor):
        pieces.append((out, (g, g, *shape)))
    else:
        pieces += [(b, (g, *shape)) for b in out]
    if len(out) != g or any(
        t.shape != want or t.dtype != dtype or t.device != device
        for t, want in pieces
    ):
        raise ValueError(
            f"out does not hold the exchange of {g} chunks of {shape} "
            f"{dtype} on {device}"
        )
    if device.type == "cpu":
        return a2a_chunk_exchange_ref(chunks, reverse=reverse, out=out)
    if device.type != "cuda":
        raise ValueError(f"a2a_chunk_exchange runs on cuda or cpu, not "
                         f"{device}")
    _launch(chunks, out, reverse, streams, device)
    return out


# Calls of the C functions since the last reset, in all and by route.
a2a_chunk_exchange.launches = 0
a2a_chunk_exchange.routes = dict.fromkeys(ROUTES, 0)


def _plan(variant, g: int, m_s: int, n_local: int):
    """(steps, m_c, reverse, blocked) of ``variant`` on g shards of m_s
    rows: the chunk count (one chunk per rank where the variant's does not
    divide the shard), the dispatch order, and whether the step GEMM is
    K1's tile (only where the variant's blocks divide the (g * m_c,
    n_local) step evenly; K stays un-blocked so each output row remains
    one full-K dot)."""
    steps = int(variant.chunks)
    if m_s % steps:
        steps = g  # promoted cut doesn't divide this shard; classic cut
    if m_s % steps:
        raise ValueError(f"{m_s} shard rows not divisible by {steps} chunks")
    m_c = m_s // steps
    rows = g * m_c
    blocked = (
        rows % variant.block_m == 0
        and n_local % variant.block_n == 0
        and (variant.block_m < rows or variant.block_n < n_local)
    )
    return steps, m_c, variant.dispatch_order == "reverse", blocked


def _step_gemm(flat, w, variant, blocked: bool, k: int) -> torch.Tensor:
    if blocked:
        return chunked_matmul(flat, w, block_m=variant.block_m,
                              block_n=variant.block_n, block_k=k)
    return torch.matmul(flat, w)


def ficco_uniform_fused_1d_dma(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    variant=None,
    copy_streams: Sequence = (),
    peers: PeerMemory | None = None,
) -> torch.Tensor:
    """uniform-fused-1D with the chunk exchange on the copy engines.

    x: (g, m_s, K), rank r's sequence shard of rows; w: (g, K, n_local),
    rank r's column shard of the weight -> (g, g * m_s, n_local), rank r's
    column block of the full product.  Per step s: exchange chunk s of
    every rank, multiply each rank's gathered (g * m_c, K) step buffer by
    its weight shard, and write row block d to row ``d * m_s + s * m_c``.
    With ``peers`` (a :class:`~repro_torch.kernels.peer_memory.PeerMemory`,
    one rank of a group of processes), x is this rank's (m_s, K) shard and
    w its (K, n_local) shard -> its (g * m_s, n_local) block, the exchange
    crossing processes through the peers' ring.

    ``variant`` (a :class:`repro_torch.tune.KernelVariant`) picks the chunk
    count, the step-GEMM tile (K1 with a full-K contraction when the tile
    divides the step GEMM, else a plain ``torch.matmul`` as the reference
    uses ``flat @ w``) and the dispatch order; ``None`` resolves the
    promoted default from :mod:`repro_torch.tune.registry`.  On CUDA,
    ``copy_streams`` (at least one) are the streams the exchange runs on:
    issued on the first, its copies spread over all (the others forked
    from the first and joined back before each step's GEMM may start).
    It refuses operands that need a gradient
    (:func:`~repro_torch.kernels.chunked_gemm.refuse_grad`), as the
    reference's ``pallas_dma`` path fails under ``jax.grad``.
    """
    refuse_grad("ficco_uniform_fused_1d_dma (K3 + K1)", x, w)
    if peers is not None:
        return _fused_1d_across(x, w, variant, copy_streams, peers)
    g, m_s, k = x.shape
    n_local = w.shape[-1]
    if w.shape != (g, k, n_local):
        raise ValueError(f"shards {tuple(x.shape)} and {tuple(w.shape)}")
    if variant is None:
        variant = resolve_variant("dma_exchange", group=g)
    steps, m_c, reverse, blocked = _plan(variant, g, m_s, n_local)
    rows = g * m_c
    out = torch.empty(
        (g, g * m_s, n_local),
        dtype=torch.promote_types(x.dtype, w.dtype),
        device=x.device,
    )
    # out[r, d * m_s + s * m_c + i] viewed as [r, d, s, i]: every row is
    # written by exactly one step.
    out_steps = out.view(g, g, steps, m_c, n_local)
    chunks = x.reshape(g, steps, m_c, k)
    bufs = [
        torch.empty((g, g, m_c, k), dtype=x.dtype, device=x.device)
        for _ in range(STEP_BUFFERS)
    ]
    order = list(range(steps))
    if reverse:
        order.reverse()

    cuda = x.device.type == "cuda"
    if cuda:
        if not copy_streams:
            raise ValueError("on CUDA the exchange needs a copy stream")
        copy_stream, side_streams = copy_streams[0], copy_streams[1:]
        compute = torch.cuda.current_stream(x.device)
        # The copies read x, which the compute stream produced.  The last
        # step's GEMM waits for the last exchange, so every copy is done
        # in compute-stream order before x or the buffers can be freed.
        copy_stream.wait_stream(compute)
        filled = [torch.cuda.Event() for _ in range(steps)]
        drained = [None] * STEP_BUFFERS

    def exchange(i: int) -> None:
        buf = bufs[i % STEP_BUFFERS]
        if not cuda:
            a2a_chunk_exchange(chunks[:, order[i]], reverse=reverse, out=buf)
            return
        with torch.cuda.stream(copy_stream):
            if drained[i % STEP_BUFFERS] is not None:
                copy_stream.wait_event(drained[i % STEP_BUFFERS])
            a2a_chunk_exchange(chunks[:, order[i]], reverse=reverse, out=buf,
                               streams=side_streams)
            filled[i].record(copy_stream)

    exchange(0)
    for i, s in enumerate(order):
        if i + 1 < steps:
            exchange(i + 1)  # issued before this step's GEMM: it overlaps
        if cuda:
            compute.wait_event(filled[i])
        flat = bufs[i % STEP_BUFFERS].view(g, rows, k)
        step_out = _step_gemm(flat, w, variant, blocked, k)
        out_steps[:, :, s] = step_out.view(g, g, m_c, n_local)
        if cuda:
            drained[i % STEP_BUFFERS] = torch.cuda.Event()
            drained[i % STEP_BUFFERS].record(compute)
    return out


def _fused_1d_across(x, w, variant, copy_streams, peers: PeerMemory):
    """:func:`ficco_uniform_fused_1d_dma` on rank r of a group of
    processes: the same plan, chunks and step GEMM as the stacked call's
    slot r, the exchange through the peers' :class:`PeerRing`, whose
    counters (not events) order the copy streams and the compute stream.
    When it returns, every copy that reads x is done in compute-stream
    order."""
    g = peers.size
    m_s, k = x.shape
    n_local = w.shape[-1]
    if w.shape != (k, n_local):
        raise ValueError(f"shards {tuple(x.shape)} and {tuple(w.shape)}")
    if variant is None:
        variant = resolve_variant("dma_exchange", group=g)
    steps, m_c, reverse, blocked = _plan(variant, g, m_s, n_local)
    out = torch.empty((g * m_s, n_local),
                      dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    out_steps = out.view(g, steps, m_c, n_local)  # [source rank, step]
    chunks = x.contiguous().view(steps, m_c, k)
    ring = peers.ring((m_c, k), x.dtype, STEP_BUFFERS)
    order = list(range(steps))
    if reverse:
        order.reverse()

    cuda = x.device.type == "cuda"
    if cuda:
        if not copy_streams:
            raise ValueError("on CUDA the exchange needs a copy stream")
        copy_stream, side_streams = copy_streams[0], copy_streams[1:]
        compute = torch.cuda.current_stream(x.device)
        copy_stream.wait_stream(compute)  # the copies read x

    def exchange(i: int) -> int:
        if not cuda:
            return a2a_chunk_exchange(chunks[order[i]], reverse=reverse,
                                      out=ring)
        with torch.cuda.stream(copy_stream):
            return a2a_chunk_exchange(chunks[order[i]], reverse=reverse,
                                      out=ring, streams=side_streams)

    pending = exchange(0)
    for i, s in enumerate(order):
        step = pending
        if i + 1 < steps:
            pending = exchange(i + 1)  # issued before this step's GEMM
        if cuda:
            ring.wait(step, compute)
        flat = ring.slot(step).view(g * m_c, k)
        step_out = _step_gemm(flat, w, variant, blocked, k)
        if cuda:
            ring.release(step, compute)
        out_steps[:, s] = step_out.view(g, m_c, n_local)
    if cuda:
        compute.wait_stream(copy_stream)
    return out


__all__ = [
    "STEP_BUFFERS",
    "ROUTES",
    "route",
    "strided_plan",
    "copy_engines",
    "a2a_chunk_exchange",
    "ficco_uniform_fused_1d_dma",
]
