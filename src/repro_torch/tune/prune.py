"""Feasibility pruning of kernel variants against hardware budgets.

Port of ``repro.tune.prune`` (a copy).

Mirrors the candidate-enumeration-with-feasibility-filtering pattern of
FPGA design-space explorers: before anything reaches the timer, a
variant must fit the machine's fast-memory (VMEM/LLC) budget, stay
inside its DMA and regular semaphore slot counts, cut the shard into
whole DMA granules, and divide the shard evenly.  Rejections carry a
human-readable reason so searches can report *why* the space shrank.

All footprints are computed for the **per-device** shapes the kernels
actually allocate (shard rows ``m/g``, local output columns ``n/g``),
from the global :class:`~repro_torch.core.workload.GemmShape`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.machine import MachineSpec
from repro_torch.core.workload import GemmShape
from repro_torch.tune.variants import KernelVariant


@dataclasses.dataclass(frozen=True)
class ResourceBudget:
    """The slice of :class:`MachineSpec` the pruner checks against."""

    vmem_bytes: int
    dma_sem_slots: int
    reg_sem_slots: int
    dma_granule: int

    @classmethod
    def from_machine(cls, machine: MachineSpec) -> "ResourceBudget":
        return cls(
            vmem_bytes=int(machine.fast_mem_bytes),
            dma_sem_slots=int(machine.dma_sem_slots),
            reg_sem_slots=int(machine.reg_sem_slots),
            dma_granule=int(machine.dma_granule),
        )


@dataclasses.dataclass(frozen=True)
class Infeasible:
    """A rejected variant plus the budget it violated."""

    variant: KernelVariant
    reason: str


def vmem_footprint(variant: KernelVariant, gemm: GemmShape, group: int) -> int:
    """Bytes of fast memory one device's kernel instance allocates."""
    g = int(group)
    b = int(gemm.dtype_bytes)
    c = variant.chunks
    d = variant.buffer_depth
    if variant.kernel == "ficco_ag_matmul":
        # Scratch mirrors the kernel: `depth` slots of (g, m_c, k) inbound
        # chunks, the resident (k, n_local) weight shard, and `depth`
        # slots of (g, m_c, n_local) outbound results.
        m_c = max(1, (gemm.m // g) // c)
        n_local = max(1, gemm.n // g)
        return b * (d * g * m_c * gemm.k + gemm.k * n_local + d * g * m_c * n_local)
    if variant.kernel == "dma_exchange":
        # One gathered (g, m_c, k) exchange buffer per step kernel, plus
        # the blocked step-GEMM working set: double-buffered input
        # panels and an f32 accumulator tile.
        m_c = max(1, (gemm.m // g) // c)
        n_local = max(1, gemm.n // g)
        gather = b * g * m_c * gemm.k
        panels = 2 * b * (
            variant.block_m * variant.block_k + variant.block_k * variant.block_n
        )
        acc = 4 * variant.block_m * variant.block_n
        return gather + panels + acc
    if variant.kernel == "ficco_a2a_ffn":
        # Per-chunk dispatch/return buffers (rows m/c of width k) plus
        # one expert-FFN panel of local width n/g.
        rows = max(1, gemm.m // c)
        n_local = max(1, gemm.n // g)
        return b * (2 * rows * gemm.k + gemm.k * n_local)
    raise ValueError(f"unknown kernel {variant.kernel!r}")


def sem_slots(variant: KernelVariant, group: int) -> tuple[int, int]:
    """(DMA completion slots, regular flow-control slots) the variant needs."""
    g = int(group)
    d = variant.buffer_depth
    if variant.kernel == "ficco_ag_matmul":
        # Per slot: g-1 send sems + g recv sems + 1 output-copy sem, and
        # one regular ready-sem per slot for remote flow control.
        return d * (g - 1) + d * g + d, d
    if variant.kernel == "dma_exchange":
        # One exchange kernel in flight: g-1 send + g recv sems.
        return (g - 1) + g, 0
    if variant.kernel == "ficco_a2a_ffn":
        # XLA collectives own their semaphores; nothing to budget.
        return 0, 0
    raise ValueError(f"unknown kernel {variant.kernel!r}")


def check_variant(
    variant: KernelVariant,
    gemm: GemmShape,
    machine: MachineSpec,
    *,
    group: int | None = None,
) -> str | None:
    """Return None if the variant is feasible, else the rejection reason."""
    g = int(group if group is not None else machine.group)
    budget = ResourceBudget.from_machine(machine)
    b = int(gemm.dtype_bytes)

    # -- divisibility: the cut must produce whole chunks ---------------
    if variant.kernel in ("ficco_ag_matmul", "dma_exchange"):
        if gemm.m % g or gemm.n % g:
            return f"indivisible: gemm {gemm.m}x{gemm.n} not shardable {g} ways"
        m_s = gemm.m // g
        if m_s % variant.chunks:
            return f"indivisible: shard rows {m_s} % chunks {variant.chunks} != 0"
        chunk_bytes = (m_s // variant.chunks) * gemm.k * b
    else:  # ficco_a2a_ffn — cuts global capacity rows
        if gemm.m % variant.chunks:
            return (
                f"indivisible: capacity {gemm.m} % chunks {variant.chunks} != 0"
            )
        chunk_bytes = (gemm.m // variant.chunks) * gemm.k * b

    # -- DMA granule: every descriptor moves whole granules ------------
    if chunk_bytes < budget.dma_granule or chunk_bytes % budget.dma_granule:
        return (
            f"dma granule: chunk {chunk_bytes}B not a whole multiple of "
            f"{budget.dma_granule}B"
        )

    # -- fast-memory footprint -----------------------------------------
    vmem = vmem_footprint(variant, gemm, g)
    if vmem > budget.vmem_bytes:
        return f"vmem: footprint {vmem}B > budget {budget.vmem_bytes}B"

    # -- semaphore slots -----------------------------------------------
    dma_s, reg_s = sem_slots(variant, g)
    if dma_s > budget.dma_sem_slots:
        return f"semaphores: {dma_s} DMA slots > budget {budget.dma_sem_slots}"
    if reg_s > budget.reg_sem_slots:
        return f"semaphores: {reg_s} regular slots > budget {budget.reg_sem_slots}"
    return None


def prune_variants(
    variants: tuple[KernelVariant, ...],
    gemm: GemmShape,
    machine: MachineSpec,
    *,
    group: int | None = None,
) -> tuple[tuple[KernelVariant, ...], tuple[Infeasible, ...]]:
    """Split an enumerated set into (feasible, rejected-with-reasons).

    Order is preserved from the input, so a deterministic enumeration
    stays deterministic through the pruner.
    """
    feasible: list[KernelVariant] = []
    rejected: list[Infeasible] = []
    for v in variants:
        reason = check_variant(v, gemm, machine, group=group)
        if reason is None:
            feasible.append(v)
        else:
            rejected.append(Infeasible(v, reason))
    return tuple(feasible), tuple(rejected)
