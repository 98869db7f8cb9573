"""K3: the FiCCO chunk exchange on the copy engines, and its composer.

Port of ``repro.kernels.dma_exchange``.  :func:`a2a_chunk_exchange` is one
FiCCO step's all-to-all: on a CUDA tensor it calls ``csrc/dma_exchange.cu``,
which issues one device-to-device ``cudaMemcpyAsync`` per (sender, slot)
pair, so the copy engines move the bytes and no SM does (the paper's
``hipMemcpyDtoDAsync`` offload).  On a CPU tensor it takes the plain
version :func:`repro_torch.kernels.ref.a2a_chunk_exchange_ref`.

:func:`ficco_uniform_fused_1d_dma` composes the exchange with the step GEMM
(K1) into uniform-fused-1D.  On the TPU, XLA's scheduler overlapped step
s+1's DMAs with step s's matmul; here the overlap is written out: the
exchange runs on the group's copy stream, the GEMMs on the compute stream,
and CUDA events order them around two step buffers.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunked_gemm import chunked_matmul
from repro_torch.kernels.ref import a2a_chunk_exchange_ref
from repro_torch.tune.variants import default_variant

# Step buffers the pipeline rotates through: step s+1's exchange fills one
# while step s's GEMM reads the other.
_DEPTH = 2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dma_exchange")
    lib.dma_exchange.restype = ctypes.c_int
    lib.dma_exchange.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def _inner_contiguous(t: torch.Tensor, lead: int) -> bool:
    """Whether every t[i_0, ..., i_{lead-1}] is one contiguous block."""
    expected = 1
    for size, stride in zip(reversed(t.shape[lead:]),
                            reversed(t.stride()[lead:])):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def _launch(chunks: torch.Tensor, out: torch.Tensor, reverse: bool) -> None:
    g = chunks.shape[0]
    if not (_inner_contiguous(chunks, 1) and _inner_contiguous(out, 2)):
        raise ValueError("a2a_chunk_exchange needs each rank's chunk and "
                         "each step-buffer slot contiguous")
    esize = chunks.element_size()
    src = (ctypes.c_void_p * g)(*[
        chunks.data_ptr() + r * chunks.stride(0) * esize for r in range(g)
    ])
    dst = (ctypes.c_void_p * (g * g))(*[
        out.data_ptr() + (r * out.stride(0) + s * out.stride(1)) * esize
        for r in range(g) for s in range(g)
    ])
    nbytes = chunks[0].numel() * esize
    lib = _lib()
    err = lib.dma_exchange(
        src, dst, nbytes, g, int(reverse),
        torch.cuda.current_stream(chunks.device).cuda_stream,
    )
    _build.check(lib, "dma_exchange", err)
    a2a_chunk_exchange.launches += 1


def a2a_chunk_exchange(
    chunks: torch.Tensor,
    *,
    reverse: bool = False,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One FiCCO exchange step: (g, m_c, K) chunks -> (g, g, m_c, K).

    ``chunks[r]`` is rank r's chunk; ``out[r, s]`` is slot s of rank r's
    step buffer and receives rank s's chunk, so every rank ends with the
    same gathered buffer (``all_gather(axis=0)``).  ``reverse`` issues the
    copies to peers in descending offset order; the result is unchanged.
    On CUDA the copies are enqueued on the current stream.
    """
    g = chunks.shape[0]
    if out is None:
        out = torch.empty(
            (g, *chunks.shape), dtype=chunks.dtype, device=chunks.device
        )
    if out.shape != (g, *chunks.shape) or out.dtype != chunks.dtype:
        raise ValueError(
            f"out {tuple(out.shape)} {out.dtype} does not hold the exchange "
            f"of {tuple(chunks.shape)} {chunks.dtype}"
        )
    if out.device != chunks.device:
        raise ValueError(f"chunks on {chunks.device}, out on {out.device}")
    if chunks.device.type == "cpu":
        return a2a_chunk_exchange_ref(chunks, reverse=reverse, out=out)
    if chunks.device.type != "cuda":
        raise ValueError(f"a2a_chunk_exchange runs on cuda or cpu, not "
                         f"{chunks.device}")
    _launch(chunks, out, reverse)
    return out


# Kernel launches (calls of the C function) since the last reset.
a2a_chunk_exchange.launches = 0


def ficco_uniform_fused_1d_dma(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    variant=None,
    copy_stream=None,
) -> torch.Tensor:
    """uniform-fused-1D with the chunk exchange on the copy engines.

    x: (g, m_s, K), rank r's sequence shard of rows; w: (g, K, n_local),
    rank r's column shard of the weight -> (g, g * m_s, n_local), rank r's
    column block of the full product.  Per step s: exchange chunk s of
    every rank, multiply each rank's gathered (g * m_c, K) step buffer by
    its weight shard, and write row block d to row ``d * m_s + s * m_c``.

    ``variant`` (a :class:`repro_torch.tune.KernelVariant`) picks the chunk
    count, the step-GEMM tile (K1 with a full-K contraction when the tile
    divides the step GEMM, else a plain ``torch.matmul`` as the reference
    uses ``flat @ w``) and the dispatch order; ``None`` is the default
    variant for the group.  On CUDA, ``copy_stream`` is the stream the
    exchange runs on.
    """
    g, m_s, k = x.shape
    n_local = w.shape[-1]
    if w.shape != (g, k, n_local):
        raise ValueError(f"shards {tuple(x.shape)} and {tuple(w.shape)}")
    if variant is None:
        variant = default_variant("dma_exchange", group=g)
    steps = int(variant.chunks)
    if m_s % steps:
        steps = g  # promoted cut doesn't divide this shard; classic cut
    if m_s % steps:
        raise ValueError(f"{m_s} shard rows not divisible by {steps} chunks")
    m_c = m_s // steps
    reverse = variant.dispatch_order == "reverse"
    rows = g * m_c
    # Tile the step GEMM only when the variant's blocks divide it evenly;
    # K stays un-blocked so each output row remains one full-K dot.
    blocked = (
        rows % variant.block_m == 0
        and n_local % variant.block_n == 0
        and (variant.block_m < rows or variant.block_n < n_local)
    )
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
        for _ in range(_DEPTH)
    ]
    order = list(range(steps))
    if reverse:
        order.reverse()

    cuda = x.device.type == "cuda"
    if cuda:
        if copy_stream is None:
            raise ValueError("on CUDA the exchange needs a copy stream")
        compute = torch.cuda.current_stream(x.device)
        # The copies read x, which the compute stream produced.  The last
        # step's GEMM waits for the last exchange, so every copy is done
        # in compute-stream order before x or the buffers can be freed.
        copy_stream.wait_stream(compute)
        filled = [torch.cuda.Event() for _ in range(steps)]
        drained = [None] * _DEPTH

    def exchange(i: int) -> None:
        buf = bufs[i % _DEPTH]
        if not cuda:
            a2a_chunk_exchange(chunks[:, order[i]], reverse=reverse, out=buf)
            return
        with torch.cuda.stream(copy_stream):
            if drained[i % _DEPTH] is not None:
                copy_stream.wait_event(drained[i % _DEPTH])
            a2a_chunk_exchange(chunks[:, order[i]], reverse=reverse, out=buf)
            filled[i].record(copy_stream)

    exchange(0)
    for i, s in enumerate(order):
        if i + 1 < steps:
            exchange(i + 1)  # issued before this step's GEMM: it overlaps
        if cuda:
            compute.wait_event(filled[i])
        flat = bufs[i % _DEPTH].view(g, rows, k)
        if blocked:
            step_out = chunked_matmul(
                flat, w,
                block_m=variant.block_m, block_n=variant.block_n, block_k=k,
            )
        else:
            step_out = torch.matmul(flat, w)
        out_steps[:, :, s] = step_out.view(g, g, m_c, n_local)
        if cuda:
            drained[i % _DEPTH] = torch.cuda.Event()
            drained[i % _DEPTH].record(compute)
    return out


__all__ = ["a2a_chunk_exchange", "ficco_uniform_fused_1d_dma"]
