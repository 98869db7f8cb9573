"""Typed kernel-variant records (copy of ``repro.tune.variants``).

A :class:`KernelVariant` pins every free shape parameter of one FiCCO
kernel: how many chunks the decomposed dimension is cut into, the M/N/K
block of the step GEMM, how many buffer slots the pipeline rotates through,
and the order chunks are dispatched in.  The port resolves a kernel's
variant to :func:`default_variant` (the variant the reference's promotion
registry returns when nothing was promoted); the search and the registry
come with the tuner.
"""

from __future__ import annotations

import dataclasses

KERNELS = ("ficco_ag_matmul", "dma_exchange", "ficco_a2a_ffn")

DISPATCH_ORDERS = ("forward", "reverse")


@dataclasses.dataclass(frozen=True, order=True)
class KernelVariant:
    """One point of a kernel's design space."""

    kernel: str
    # Number of chunks the decomposed dimension (shard rows / expert
    # capacity) is cut into == pipeline steps.
    chunks: int
    # Step-GEMM output tile (M x N) and contraction block (K).
    block_m: int
    block_n: int
    block_k: int
    # Buffer slots the pipeline rotates through: 2 = classic double
    # buffering, 3+ = deeper in-flight window for skewed step lists.
    buffer_depth: int = 2
    dispatch_order: str = "forward"

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"unknown kernel {self.kernel!r}; known: {KERNELS}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.buffer_depth < 2:
            # A single slot would be overwritten by the next inbound copy
            # while the compute step still reads it.
            raise ValueError("buffer_depth < 2 races the copy against compute")
        if self.dispatch_order not in DISPATCH_ORDERS:
            raise ValueError(
                f"dispatch_order {self.dispatch_order!r} not in {DISPATCH_ORDERS}"
            )
        if min(self.block_m, self.block_n, self.block_k) < 8:
            raise ValueError("tile blocks must be >= 8")


def default_variant(kernel: str, *, group: int | None = None) -> KernelVariant:
    """The single variant the kernels shipped with before the search.

    One chunk per group member, a 128 x 128 x 128 GEMM tile, double
    buffering, forward dispatch.
    """
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; known: {KERNELS}")
    return KernelVariant(
        kernel=kernel,
        chunks=int(group if group is not None else 8),
        block_m=128,
        block_n=128,
        block_k=128,
        buffer_depth=2,
        dispatch_order="forward",
    )


__all__ = ["KERNELS", "DISPATCH_ORDERS", "KernelVariant", "default_variant"]
