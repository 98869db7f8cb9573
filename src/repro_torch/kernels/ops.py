"""Public wrappers around the kernels (port of ``repro.kernels.ops``).

The reference's wrappers pick Pallas's interpret mode off the TPU; here
the kernels pick their route from the tensor's device (CUDA: the
hand-written kernel; CPU: its plain version).  Each kernel counts its CUDA
launches on the function that launches it; :func:`launch_counts` reads
them and :func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

from repro_torch.kernels.chunked_gemm import chunked_matmul
from repro_torch.kernels.dma_exchange import (
    a2a_chunk_exchange,
    ficco_uniform_fused_1d_dma,
)

# The kernels of this package by the name of the TPU kernel each replaces.
KERNELS = {
    "chunked_matmul": chunked_matmul,
    "a2a_chunk_exchange": a2a_chunk_exchange,
}


def matmul(x, w, *, block_m=128, block_n=128, block_k=128):
    return chunked_matmul(
        x, w, block_m=block_m, block_n=block_n, block_k=block_k
    )


def chunk_exchange(chunks, *, reverse=False):
    """All-to-all of one FiCCO chunk across the stacked ranks."""
    return a2a_chunk_exchange(chunks, reverse=reverse)


def ag_matmul_dma(x, w, *, group):
    """uniform-fused-1D with the exchange on ``group``'s copy stream."""
    return ficco_uniform_fused_1d_dma(x, w, copy_stream=group.copy_stream)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "matmul",
    "chunk_exchange",
    "ag_matmul_dma",
    "launch_counts",
    "reset_launch_counts",
]
