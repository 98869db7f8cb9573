"""Typed kernel-variant records and deterministic enumeration.

Port of ``repro.tune.variants`` (a copy: the port imports nothing of
``repro``).

A :class:`KernelVariant` pins every free shape parameter of one FiCCO
kernel: how many chunks the decomposed dimension is cut into, the M/N/K
block of the step GEMM, how many DMA buffer slots the pipeline rotates
through (double/triple/n-slot), and the order chunks are dispatched in
(forward or reverse — reverse front-loads the tail steps of a skewed
profile).  Variants are frozen, ordered, and hashable so enumeration
order, cache keys, and promotion artifacts are all deterministic.

Not every kernel exposes every axis (``VARIANT_AXES``): the fused
all-gather GEMM performs one full-width dot per step, so its tile is the
machine's native tile; the chunked-exchange schedule launches one GEMM
per step, so its tile *is* searchable (in the port it decides between K1,
when the tile divides the step GEMM, and ``torch.matmul``); the MoE
all-to-all FFN only chooses chunk count and dispatch order.
"""

from __future__ import annotations

import dataclasses
import re
from typing import TYPE_CHECKING

from repro_torch.core.schedule_types import Schedule

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.machine import MachineSpec

KERNELS = ("ficco_ag_matmul", "dma_exchange", "ficco_a2a_ffn")

DISPATCH_ORDERS = ("forward", "reverse")

# The grid-schedule row each kernel realizes: all three are chunked
# 1D pipelines, so their measured times calibrate the uniform-fused-1d
# lane of the analytic model (and the ragged lanes when profile-keyed).
KERNEL_SCHEDULE = {
    "ficco_ag_matmul": Schedule.UNIFORM_FUSED_1D,
    "dma_exchange": Schedule.UNIFORM_FUSED_1D,
    "ficco_a2a_ffn": Schedule.UNIFORM_FUSED_1D,
}

# Which variant axes each kernel actually exposes; the rest stay at the
# structural default from `default_variant`.
VARIANT_AXES = {
    "ficco_ag_matmul": ("chunks", "depth", "order"),
    "dma_exchange": ("chunks", "tile", "order"),
    "ficco_a2a_ffn": ("chunks", "order"),
}

_DIGEST_RE = re.compile(r"c(\d+)t(\d+)x(\d+)x(\d+)d(\d+)([fr])")


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
    # DMA buffer slots the pipeline rotates through: 2 = classic double
    # buffering, 3+ = deeper in-flight window for skewed step lists.
    buffer_depth: int = 2
    dispatch_order: str = "forward"

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"unknown kernel {self.kernel!r}; known: {KERNELS}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.buffer_depth < 2:
            # A single slot would be overwritten by the next inbound DMA
            # while the compute step still reads it.
            raise ValueError("buffer_depth < 2 races DMA against compute")
        if self.dispatch_order not in DISPATCH_ORDERS:
            raise ValueError(
                f"dispatch_order {self.dispatch_order!r} not in {DISPATCH_ORDERS}"
            )
        if min(self.block_m, self.block_n, self.block_k) < 8:
            raise ValueError("tile blocks must be >= 8")

    # ---- identity -----------------------------------------------------
    def digest(self) -> str:
        """Compact spelling used in cache keys and artifacts."""
        return (
            f"c{self.chunks}t{self.block_m}x{self.block_n}x{self.block_k}"
            f"d{self.buffer_depth}{self.dispatch_order[0]}"
        )

    @property
    def key_segment(self) -> str:
        """The trailing `TuneKey` segment: ``v`` + digest."""
        return "v" + self.digest()

    @classmethod
    def from_digest(cls, kernel: str, digest: str) -> "KernelVariant":
        m = _DIGEST_RE.fullmatch(digest)
        if m is None:
            raise ValueError(f"malformed variant digest {digest!r}")
        c, bm, bn, bk, d, o = m.groups()
        return cls(
            kernel=kernel,
            chunks=int(c),
            block_m=int(bm),
            block_n=int(bn),
            block_k=int(bk),
            buffer_depth=int(d),
            dispatch_order="forward" if o == "f" else "reverse",
        )

    # ---- persistence --------------------------------------------------
    def to_payload(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_payload(cls, payload: dict) -> "KernelVariant":
        return cls(**payload)


def default_variant(
    kernel: str,
    machine: "MachineSpec | None" = None,
    *,
    group: int | None = None,
) -> KernelVariant:
    """The single variant the kernels shipped with before the search.

    One chunk per group member, the machine's native GEMM tile, double
    buffering, forward dispatch.
    """
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; known: {KERNELS}")
    g = int(group if group is not None else (machine.group if machine else 8))
    bm = int(machine.tile_mn) if machine is not None else 128
    bk = int(machine.tile_k) if machine is not None else 128
    return KernelVariant(
        kernel=kernel,
        chunks=g,
        block_m=bm,
        block_n=bm,
        block_k=bk,
        buffer_depth=2,
        dispatch_order="forward",
    )


def enumerate_variants(
    kernel: str,
    machine: "MachineSpec | None" = None,
    *,
    group: int | None = None,
    chunk_counts: tuple[int, ...] | None = None,
    tile_scales: tuple[float, ...] = (0.5, 1.0, 2.0),
    depths: tuple[int, ...] = (2, 3),
    orders: tuple[str, ...] = DISPATCH_ORDERS,
) -> tuple[KernelVariant, ...]:
    """Deterministically enumerate a kernel's variant space.

    The candidate set is the cross product of the axes the kernel
    exposes (``VARIANT_AXES``); axes it does not expose stay pinned at
    the default.  The result is duplicate-free and sorted by the
    variant's natural (field-lexicographic) order, so two calls with the
    same arguments return the same tuple in the same order.
    """
    base = default_variant(kernel, machine, group=group)
    axes = VARIANT_AXES[kernel]
    g = base.chunks

    if chunk_counts is None:
        chunk_counts = tuple(
            sorted({c for c in (g // 2, g, 2 * g) if c >= 2})
        )
    chunk_axis = chunk_counts if "chunks" in axes else (base.chunks,)

    if "tile" in axes:
        tiles = sorted(
            {
                (
                    max(64, int(base.block_m * s)),
                    max(64, int(base.block_n * s)),
                    max(64, int(base.block_k * s)),
                )
                for s in tile_scales
            }
        )
    else:
        tiles = [(base.block_m, base.block_n, base.block_k)]

    depth_axis = depths if "depth" in axes else (base.buffer_depth,)
    order_axis = orders if "order" in axes else (base.dispatch_order,)

    out = {
        KernelVariant(
            kernel=kernel,
            chunks=c,
            block_m=tm,
            block_n=tn,
            block_k=tk,
            buffer_depth=d,
            dispatch_order=o,
        )
        for c in chunk_axis
        for (tm, tn, tk) in tiles
        for d in depth_axis
        for o in order_axis
    }
    out.add(base)  # the incumbent is always a candidate
    return tuple(sorted(out))


__all__ = [
    "KERNELS",
    "DISPATCH_ORDERS",
    "KERNEL_SCHEDULE",
    "VARIANT_AXES",
    "KernelVariant",
    "default_variant",
    "enumerate_variants",
]
