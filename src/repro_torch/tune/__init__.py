"""Kernel-variant autotuning: enumerate, prune, measure, promote.

Port of ``repro.tune``.  The FiCCO kernels (`ficco_ag_matmul_fused`,
the `dma_exchange` schedule, `ficco_a2a_ffn`) each admit a family of
shapes — chunk count, tile shape, DMA buffer depth, dispatch order — that
the analytic engines silently assumed.  This package closes the
kernel-level sim-to-real loop:

- :mod:`repro_torch.tune.variants` — typed :class:`KernelVariant` records
  with deterministic enumeration of the per-kernel design space.
- :mod:`repro_torch.tune.prune` — feasibility pruning against the
  resource budgets carried by :class:`~repro_torch.core.machine.MachineSpec`
  (VMEM footprint, DMA/regular semaphore slots, min-DMA-granule
  alignment, divisibility).
- :mod:`repro_torch.tune.cost` — a deterministic discrete-event cost model
  for one variant (wave-quantized step GEMMs + depth-``d`` slot recurrence),
  the stand-in for device timing when no runner is given.
- :mod:`repro_torch.tune.search` — time the feasible set through
  :meth:`Autotuner.measure_variants`, persist variant-keyed records, and
  promote per-(machine-family, scenario-class) winners.
- :mod:`repro_torch.tune.registry` — the promotion registry the kernels
  consult when called without an explicit ``variant=``.
"""

from repro_torch.tune.variants import (
    DISPATCH_ORDERS,
    KERNELS,
    KERNEL_SCHEDULE,
    KernelVariant,
    default_variant,
    enumerate_variants,
)
from repro_torch.tune.prune import (
    Infeasible,
    ResourceBudget,
    check_variant,
    prune_variants,
)
from repro_torch.tune.cost import variant_cost
from repro_torch.tune.search import SearchResult, search_kernel_variants
from repro_torch.tune.registry import (
    VARIANT_ARTIFACT_KIND,
    promote_variant,
    reset_variants,
    resolve_variant,
    set_variant,
)

__all__ = [
    "DISPATCH_ORDERS",
    "KERNELS",
    "KERNEL_SCHEDULE",
    "KernelVariant",
    "default_variant",
    "enumerate_variants",
    "Infeasible",
    "ResourceBudget",
    "check_variant",
    "prune_variants",
    "variant_cost",
    "SearchResult",
    "search_kernel_variants",
    "VARIANT_ARTIFACT_KIND",
    "promote_variant",
    "reset_variants",
    "resolve_variant",
    "set_variant",
]
