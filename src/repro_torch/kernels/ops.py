"""Public wrappers around the kernels (port of ``repro.kernels.ops``).

The reference's wrappers pick Pallas's interpret mode off the TPU; here
the kernels pick their route from the tensor's device (CUDA: the
hand-written kernel; CPU: its plain version).  Each kernel counts its CUDA
launches on the function that launches it; :func:`launch_counts` reads
them, :func:`route_counts` reads their counts by route, and
:func:`reset_launch_counts` sets them all to 0.
"""

from __future__ import annotations

from repro_torch.kernels.chunked_gemm import accumulate_matmul, chunked_matmul
from repro_torch.kernels.dma_exchange import (
    a2a_chunk_exchange,
    ficco_uniform_fused_1d_dma,
)
from repro_torch.kernels.ficco_ag_matmul import ficco_ag_matmul_fused

# The kernels of this package by the name of the TPU kernel each replaces.
KERNELS = {
    "chunked_matmul": chunked_matmul,
    "accumulate_matmul": accumulate_matmul,
    "a2a_chunk_exchange": a2a_chunk_exchange,
    "ficco_ag_matmul_fused": ficco_ag_matmul_fused,
}


def matmul(x, w, *, block_m=128, block_n=128, block_k=128):
    """x @ w with an fp32 sum (K1); refuses operands that need a gradient."""
    return chunked_matmul(
        x, w, block_m=block_m, block_n=block_n, block_k=block_k
    )


def matmul_accumulate(c, x, w):
    """C += x @ w in place (K2); returns C, the update recorded for
    autograd when an operand needs a gradient."""
    return accumulate_matmul(c, x, w)


def chunk_exchange(chunks, *, reverse=False):
    """All-to-all of one FiCCO chunk across the stacked ranks."""
    return a2a_chunk_exchange(chunks, reverse=reverse)


def ag_matmul_dma(x, w, *, group):
    """uniform-fused-1D with the exchange on ``group``'s copy streams;
    refuses operands that need a gradient."""
    return ficco_uniform_fused_1d_dma(x, w, copy_streams=group.copy_streams)


def ag_matmul_fused(x, w, *, variant=None):
    """The fused all-gather + step GEMM of every rank in one launch (K4);
    refuses operands that need a gradient."""
    return ficco_ag_matmul_fused(x, w, variant=variant)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> dict[str, dict[str, int]]:
    """Launches by route of the kernels that choose one (K1-K4)."""
    return {name: dict(fn.routes) for name, fn in KERNELS.items()
            if hasattr(fn, "routes")}


def reset_launch_counts() -> None:
    """Sets every launch count, and every per-route count, to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "routes"):
            fn.routes = dict.fromkeys(fn.routes, 0)


__all__ = [
    "KERNELS",
    "matmul",
    "matmul_accumulate",
    "chunk_exchange",
    "ag_matmul_dma",
    "ag_matmul_fused",
    "launch_counts",
    "route_counts",
    "reset_launch_counts",
]
