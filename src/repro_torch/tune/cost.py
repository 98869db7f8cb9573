"""Deterministic discrete-event cost of one kernel variant.

Port of ``repro.tune.cost`` (a copy).

The interpret-mode stand-in for wall-clock timing: CI boxes have no
accelerator, so the search times variants through this model unless the
caller supplies a real ``runner``.  It is intentionally *finer-grained*
than the analytic schedule engines — it sees the variant's chunk count,
tile shape (through wave quantization), buffer depth (through the slot
recurrence), and dispatch order (through the step-size permutation) —
which is exactly what makes the search non-trivial: differently-shaped
variants of the same schedule get different times.

Model, per step ``i`` carrying fraction ``f_i`` of the work:

- comm:   ``t_comm[i] = f_i * shard_bytes * (g-1) / ag_bw + link_latency``
- compute: wave-quantized GEMM — output tiles ``ceil(rows/bm) *
  ceil(n_local/bn)`` spread over ``parallel_units``; each wave costs
  ``2*bm*bn*k / peak_flops``; plus per-step launch overhead
  (``kernel_latency`` when the pipeline is one fused kernel,
  ``+ kernel_ramp`` when every step launches its own kernel).
- pipeline with ``d`` buffer slots: the DMA for step ``i`` cannot start
  until the compute of step ``i-d`` has released its slot.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

from repro_torch.core.machine import MachineSpec, machine_for_group
from repro_torch.core.workload import GemmShape
from repro_torch.tune.variants import KernelVariant

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.workload import StepProfile

# Kernels whose whole pipeline is one fused kernel (DMA issued
# from inside) vs. one launched kernel/collective per step.
_FUSED = {
    "ficco_ag_matmul": True,
    "dma_exchange": False,
    "ficco_a2a_ffn": False,
}


def step_fractions(
    variant: KernelVariant, profile: "StepProfile | None" = None
) -> tuple[float, ...]:
    """The per-step work shares the variant executes, in dispatch order."""
    if profile is not None:
        fracs = list(profile.trimmed().fractions)
    else:
        fracs = [1.0 / variant.chunks] * variant.chunks
    if variant.dispatch_order == "reverse":
        fracs.reverse()
    return tuple(fracs)


def variant_cost(
    variant: KernelVariant,
    gemm: GemmShape,
    machine: MachineSpec,
    *,
    group: int | None = None,
    profile: "StepProfile | None" = None,
) -> float:
    """Modeled seconds for one variant of one kernel on one machine."""
    eff = machine_for_group(machine, int(group)) if group else machine
    g = eff.group
    b = float(gemm.dtype_bytes)
    n_local = max(1, gemm.n // g)
    fracs = step_fractions(variant, profile)

    # Whole-op egress per device: its shard to g-1 peers (AG) or the
    # dispatched capacity rows (A2A) — both scale with m*k/g.
    total_comm_bytes = (gemm.m / g) * gemm.k * b * (g - 1)
    t_comm = [
        f * total_comm_bytes / eff.ag_bw + eff.link_latency for f in fracs
    ]

    bm, bn = variant.block_m, variant.block_n
    per_wave = 2.0 * bm * bn * gemm.k / eff.peak_flops
    overhead = eff.kernel_latency
    if not _FUSED[variant.kernel]:
        overhead += eff.kernel_ramp

    def gemm_time(rows: float) -> float:
        tiles = math.ceil(max(1.0, rows) / bm) * math.ceil(n_local / bn)
        waves = math.ceil(tiles / eff.parallel_units)
        return waves * per_wave

    t_cmp = [gemm_time(f * gemm.m) + overhead for f in fracs]

    # Depth-d slot recurrence: comm for step i waits on the slot freed
    # by compute step i-d; compute chains on its own predecessor and on
    # the arrival of its chunk.
    d = variant.buffer_depth
    comm_done: list[float] = []
    cmp_done: list[float] = []
    for i in range(len(fracs)):
        start = comm_done[i - 1] if i else 0.0
        if i >= d:
            start = max(start, cmp_done[i - d])
        comm_done.append(start + t_comm[i])
        c_start = max(comm_done[i], cmp_done[i - 1] if i else 0.0)
        cmp_done.append(c_start + t_cmp[i])
    # One pipeline fill (first kernel's cold ramp) for the fused path;
    # the unfused paths already pay ramp per step.
    fill = eff.kernel_ramp if _FUSED[variant.kernel] else 0.0
    return cmp_done[-1] + fill
