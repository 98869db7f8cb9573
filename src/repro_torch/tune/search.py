"""Kernel-variant search: enumerate → prune → time → record → promote.

Port of ``repro.tune.search`` (a copy; the machine defaults to
:data:`~repro_torch.core.machine.H100_SXM`).

One call closes the loop for one (kernel, GEMM, machine, profile)
context: the feasible set is timed through
:meth:`Autotuner.measure_variants` (variant-keyed 8-segment cache
records, the `fit_machine` food), the winner is *also* recorded at the
plain 7-segment profile-keyed key with ``source="measured"`` — exactly
the record the reference's ``learn.measured.MeasuredEngine`` and the tier-1
cache lookup consume — and promoted in :mod:`repro_torch.tune.registry` so
subsequent kernel invocations default to it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Callable, Sequence

from repro_torch.core.machine import H100_SXM, MachineSpec, machine_for_group
from repro_torch.core.workload import GemmShape
from repro_torch.tune.cost import variant_cost
from repro_torch.tune.prune import Infeasible, prune_variants
from repro_torch.tune.registry import promote_variant
from repro_torch.tune.variants import (
    KERNEL_SCHEDULE,
    KernelVariant,
    default_variant,
    enumerate_variants,
)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.autotune.tuner import Autotuner
    from repro_torch.core.workload import StepProfile


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Everything one variant search learned."""

    kernel: str
    machine: str
    group: int
    n_enumerated: int
    n_feasible: int
    rejected: tuple[Infeasible, ...]
    # (variant, seconds) for every feasible candidate, input order.
    timings: tuple[tuple[KernelVariant, float], ...]
    best: KernelVariant
    best_seconds: float
    default: KernelVariant
    default_seconds: float
    # Wall-clock seconds the search itself took.
    seconds: float

    @property
    def speedup(self) -> float:
        """Best-vs-default: > 1 means the search beat the incumbent."""
        return self.default_seconds / self.best_seconds if self.best_seconds else 1.0


def search_kernel_variants(
    kernel: str,
    gemm: GemmShape,
    machine: MachineSpec | None = None,
    *,
    group: int | None = None,
    profile: "StepProfile | None" = None,
    tuner: "Autotuner | None" = None,
    variants: Sequence[KernelVariant] | None = None,
    runner: Callable[[KernelVariant], float] | None = None,
    promote: bool = True,
) -> SearchResult:
    """Search one kernel's variant space for one GEMM on one machine.

    ``runner(variant) -> seconds`` times a variant for real; ``None``
    falls back to the deterministic variant cost model.  ``promote=False``
    measures and records without touching the promotion registry or the
    plain schedule-decision key.
    """
    t0 = time.perf_counter()
    machine = machine or H100_SXM
    g = int(group if group is not None else machine.group)
    eff = machine_for_group(machine, g)
    if tuner is None:
        from repro_torch.autotune.tuner import get_tuner

        tuner = get_tuner()

    cands = (
        tuple(variants)
        if variants is not None
        else enumerate_variants(kernel, eff, group=g)
    )
    feasible, rejected = prune_variants(cands, gemm, eff, group=g)
    default = default_variant(kernel, eff, group=g)

    timings = tuple(
        tuner.measure_variants(
            kernel,
            gemm,
            feasible,
            machine=machine,
            group=g,
            profile=profile,
            runner=runner,
        )
    )
    if timings:
        best, best_seconds = min(timings, key=lambda vt: vt[1])
    else:
        # Nothing feasible: fall back to the incumbent, modeled.
        best = default
        best_seconds = variant_cost(default, gemm, eff, profile=profile)

    by_variant = dict(timings)
    default_seconds = by_variant.get(default)
    if default_seconds is None:
        default_seconds = variant_cost(default, gemm, eff, profile=profile)

    if promote:
        # The winner's time is the kernel's realized schedule time: write
        # it at the plain profile-keyed decision record the MeasuredEngine
        # shortlist and tier-1 cache lookups consume.
        from repro_torch.autotune.tuner import TuneKey

        key = str(TuneKey.for_gemm(gemm, machine, g, profile=profile))
        tuner.cache.put(
            key,
            {
                "schedule": KERNEL_SCHEDULE[kernel].value,
                "source": "measured",
                "model_total_s": None,
                "measured_total_s": float(best_seconds),
                "kernel": kernel,
                "variant": best.digest(),
            },
            persist=tuner.persist,
        )
        promote_variant(
            kernel,
            best,
            machine=machine,
            profile=profile,
            cache=tuner.cache,
            persist=tuner.persist,
        )

    return SearchResult(
        kernel=kernel,
        machine=machine.name,
        group=g,
        n_enumerated=len(cands),
        n_feasible=len(feasible),
        rejected=rejected,
        timings=timings,
        best=best,
        best_seconds=float(best_seconds),
        default=default,
        default_seconds=float(default_seconds),
        seconds=time.perf_counter() - t0,
    )
