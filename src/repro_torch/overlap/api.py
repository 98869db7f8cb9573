"""Public overlap API: heuristic-driven bespoke schedules (paper §VI-A).

Port of ``repro.overlap.api``.  "To incorporate FiCCO, the user provides
only the GEMM inputs; based on the GEMM dimensions our heuristic will
select and execute the optimum overlap schedule, replacing the serial
communication and computation."

:func:`ficco_linear` is that entry point over a logical group's stacked
ranks: ``schedule="auto"`` consults
:func:`repro_torch.core.heuristics.select_schedule` with the *static*
global GEMM dimensions — no profiling — and dispatches the chosen schedule.
The machine defaults to :data:`~repro_torch.core.machine.H100_SXM`.
``schedule="autotune"`` asks the process-wide runtime tuner
(:func:`repro_torch.autotune.get_tuner`): a cached (analytic or measured)
decision, else the analytic ranking; should the tuner raise, the static
heuristic answers, counted as ``overlap/resolve.autotune_fallback``.
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.autotune import get_tuner
from repro_torch.core.heuristics import select_schedule
from repro_torch.core.machine import H100_SXM, MachineSpec, machine_for_group
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import GemmShape
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.overlap.schedules import SCHEDULE_FNS, run_schedule

ScheduleLike = Union[Schedule, str]


def resolve_schedule(
    schedule: ScheduleLike,
    *,
    m: int,
    n: int,
    k: int,
    machine: MachineSpec | None = None,
    dtype_bytes: int = 2,
    group: int | None = None,
) -> Schedule:
    """Static schedule resolution from the global GEMM's shape.

    ``group`` is the actual overlap-group size; the decision tree (and in
    particular its group-sensitive serial gate) is evaluated against the
    machine model retargeted at that group, not the model's default.
    Each resolution is an ``overlap/resolve`` span and bumps
    ``overlap/resolve.{how}`` (``explicit``, ``named``, ``auto``,
    ``autotune`` or ``autotune_fallback``), as in the reference.
    """
    def _resolved(how: str, sched: Schedule, sp) -> Schedule:
        _metrics.get_metrics().counter(f"overlap/resolve.{how}").inc()
        sp.set(how=how, schedule=sched.value)
        return sched

    with _trace.span(
        "overlap/resolve", "overlap", m=m, n=n, k=k, group=group,
    ) as sp:
        if isinstance(schedule, Schedule):
            return _resolved("explicit", schedule, sp)
        eff = machine or H100_SXM
        if group:
            eff = machine_for_group(eff, group)
        if schedule == "autotune":
            gemm = GemmShape(m, n, k, dtype_bytes)
            try:
                sched = get_tuner().pick(gemm, machine, group=group).schedule
                return _resolved("autotune", sched, sp)
            except Exception:
                # Zero-cost fallback: the static decision tree.
                sched = select_schedule(gemm, eff).schedule
                return _resolved("autotune_fallback", sched, sp)
        if schedule != "auto":
            return _resolved("named", Schedule(schedule), sp)
        dec = select_schedule(GemmShape(m, n, k, dtype_bytes), eff)
        # The serial guard may also fire for shapes the schedules can't
        # chunk.
        return _resolved("auto", dec.schedule, sp)


def _divisible(m_s: int, k: int, g: int, sched: Schedule) -> bool:
    if sched in (Schedule.SERIAL,):
        return True
    if sched is Schedule.UNIFORM_FUSED_2D:
        return k % g == 0
    if sched is Schedule.SHARD_P2P:
        return True
    return m_s % g == 0  # 1D FiCCO chunks rows one level deeper


def ficco_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    schedule: ScheduleLike = "auto",
    machine: MachineSpec | None = None,
) -> torch.Tensor:
    """Data-dependent AG->GEMM with a bespoke overlap schedule.

    Args:
      x: (g, M/g, K), rank r's row shard of the activation at [r].
      w: (g, K, N/g), rank r's resident column shard of the weight at [r]
        (``repro_torch.parallel.sharding.shard_columns``).
      schedule: explicit :class:`Schedule`, its string value, "auto"
        (static heuristic) or "autotune" (the runtime tuner).
      machine: the machine the heuristic decides for (default H100_SXM).

    Returns:
      (g, M, N/g): on every rank, the full gathered-M rows times that
      rank's weight columns.
    """
    g, m_s, k = x.shape
    n_local = w.shape[-1]
    sched = resolve_schedule(
        schedule,
        m=m_s * g,
        n=n_local * g,
        k=k,
        machine=machine,
        dtype_bytes=x.element_size(),
        group=g,
    )
    if not _divisible(m_s, k, g, sched):
        sched = Schedule.SERIAL  # shape can't be chunked one level deeper
    return run_schedule(sched, x, w)


__all__ = [
    "Schedule",
    "SCHEDULE_FNS",
    "ficco_linear",
    "resolve_schedule",
    "run_schedule",
]
