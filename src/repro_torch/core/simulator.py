"""Discrete two-resource schedule simulator (paper Fig. 6 / Fig. 11b; port
of ``repro.core.simulator``).

Every schedule is lowered to two serially-ordered work queues — a *comm
channel* (link DMAs) and a *compute channel* (GEMM + Gather/Scatter HBM
moves) — plus dependencies "compute step i needs comm step j".  The pipeline
recurrence then yields the end-to-end time:

    finish_comm[j]  = finish_comm[j-1] + comm[j]
    start_comp[i]   = max(finish_comp[i-1], finish_comm[dep(i)])
    total           = finish_comp[-1]

DIL is *not* injected: it emerges from the per-chunk roofline in
``inefficiency.gemm_exec`` (weight re-reads, launch latencies, tile
quantization).  CIL multiplies each stream's step times according to the
schedule's concurrency degree, matching the paper's calibrated geomeans.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import inefficiency as ineff
from repro_torch.core import schedule_types as _su
from repro_torch.core.machine import MachineSpec
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import GemmShape, StepProfile


@dataclasses.dataclass(frozen=True)
class SimResult:
    schedule: Schedule
    total: float
    comm_busy: float
    compute_busy: float
    exposed_comm: float
    steps: int
    # Isolated single-op reference times:
    serial_comm: float
    serial_gemm: float

    @property
    def serial_total(self) -> float:
        return self.serial_comm + self.serial_gemm

    @property
    def speedup(self) -> float:
        return self.serial_total / self.total

    @property
    def ideal_total(self) -> float:
        """Perfect overlap, zero DIL/CIL (paper's 'Ideal Execution')."""
        return max(self.serial_comm, self.serial_gemm)

    @property
    def ideal_speedup(self) -> float:
        return self.serial_total / self.ideal_total


@dataclasses.dataclass(frozen=True)
class ScheduleSteps:
    """A schedule lowered to its two work queues, before the pipeline runs.

    This is the intermediate representation ``simulate`` always built
    internally and then discarded; it is public so observability tooling
    (the reference's ``obs/timeline.py``) can render the per-step
    comm/compute lanes of any schedule without re-deriving the lowering.  ``run()``
    feeds the queues through the same pipeline recurrence ``simulate``
    uses — results are bit-identical to ``simulate``'s.

    ``comm_active``/``comp_active`` are the ragged path's step masks
    (None on uniform schedules).  ``comm_cil``/``gemm_cil`` record the
    contention factors applied to the *step* streams (None when the
    lowering applies them per-step internally, i.e. ragged), and
    ``local_first`` marks ``compute[0]`` as the un-communicated local
    shard GEMM (hetero FiCCO variants and shard-P2P).
    """

    schedule: Schedule
    comm: tuple[float, ...]
    compute: tuple[float, ...]
    deps: tuple[int | None, ...]
    steps: int
    serial_comm: float
    serial_gemm: float
    comm_active: tuple[bool, ...] | None = None
    comp_active: tuple[bool, ...] | None = None
    comm_cil: float | None = None
    gemm_cil: float | None = None
    local_first: bool = False

    def run(self) -> SimResult:
        if self.comm_active is not None:
            total, exposed, comm_busy, compute_busy = _pipeline_masked(
                list(self.comm),
                list(self.compute),
                list(self.deps),
                list(self.comm_active),
                list(self.comp_active),
            )
        else:
            total, exposed = _pipeline(
                list(self.comm), list(self.compute), list(self.deps)
            )
            comm_busy = sum(self.comm)
            compute_busy = sum(self.compute)
        return SimResult(
            self.schedule, total, comm_busy, compute_busy, exposed,
            self.steps, self.serial_comm, self.serial_gemm,
        )


def _pipeline(
    comm: list[float], compute: list[float], deps: list[int | None]
) -> tuple[float, float]:
    """Run the two-channel pipeline; returns (total, exposed_comm)."""
    finish_comm: list[float] = []
    t = 0.0
    for c in comm:
        t += c
        finish_comm.append(t)
    t_comp = 0.0
    exposed = 0.0
    for i, work in enumerate(compute):
        dep = deps[i]
        ready = finish_comm[dep] if dep is not None else 0.0
        if ready > t_comp:
            exposed += ready - t_comp
            t_comp = ready
        t_comp += work
    return max(t_comp, finish_comm[-1] if finish_comm else 0.0), exposed


def _pipeline_masked(
    comm: list[float],
    compute: list[float],
    deps: list[int | None],
    comm_active: list[bool],
    comp_active: list[bool],
) -> tuple[float, float, float, float]:
    """Masked ragged pipeline: the scalar twin of the batched engines'
    masked scan (``batch.pipeline_vec`` with masks).

    Inactive steps add exactly 0.0 time on their channel and can never
    stall the compute channel, so a zero-padded profile reproduces its
    trimmed recurrence bit-for-bit.  Returns ``(total, exposed,
    comm_busy, compute_busy)``.
    """
    finish: list[float] = []
    t = 0.0
    for c, a in zip(comm, comm_active):
        t = t + (c if a else 0.0)
        finish.append(t)
    t_comp = 0.0
    exposed = 0.0
    comp_sum = 0.0
    for i, work in enumerate(compute):
        a = comp_active[i]
        w = work if a else 0.0
        dep = deps[i]
        if dep is not None and a:
            ready = finish[dep]
            if ready > t_comp:
                exposed += ready - t_comp
                t_comp = ready
        t_comp += w
        comp_sum += w
    comm_sum = finish[-1] if finish else 0.0
    return max(t_comp, comm_sum), exposed, comm_sum, comp_sum


def simulate(
    gemm: GemmShape,
    machine: MachineSpec,
    schedule: Schedule,
    *,
    dma: bool = True,
    dma_into_place: bool = False,
    profile: StepProfile | None = None,
) -> SimResult:
    """Simulate one data-dependent AG->GEMM (or A2A->GEMM) scenario.

    ``dma_into_place`` models the beyond-paper fused kernel (K4,
    ``repro_torch.kernels.ficco_ag_matmul``): chunks land directly in the
    step buffer and outputs are written in place, eliminating the Gather /
    Scatter streams — lower concurrency degree AND no gather/scatter
    residual time.  On the paper's GPU realization those streams exist
    because receive buffers are separate (hence uniform schedules' HIGH
    CIL signature); strided copies into the step buffer remove them.

    ``profile`` selects the **ragged** path: per-step chunk sizes follow
    the :class:`~repro_torch.core.workload.StepProfile` (capacity-skewed EP
    dispatch, hetero-chunk FiCCO variants) instead of the paper's
    uniform 1/g split.  SERIAL and SHARD_P2P are profile-independent —
    they move the same aggregate bytes whatever the skew — so a profile
    passed with those schedules is accepted and ignored.
    """
    return schedule_steps(
        gemm, machine, schedule,
        dma=dma, dma_into_place=dma_into_place, profile=profile,
    ).run()


def schedule_steps(
    gemm: GemmShape,
    machine: MachineSpec,
    schedule: Schedule,
    *,
    dma: bool = True,
    dma_into_place: bool = False,
    profile: StepProfile | None = None,
) -> ScheduleSteps:
    """Lower one scenario to its per-step comm/compute work queues.

    This is :func:`simulate` stopped one stage early:
    ``schedule_steps(...).run()`` *is* ``simulate(...)``, bit for bit.
    The exposed queues are what the schedule-timeline exporter renders
    as Perfetto lanes.
    """
    g = machine.group
    b = gemm.dtype_bytes
    # Per-device GEMM: TP column-shards the weight over the group, so the
    # data-dependent GEMM each device runs is (M, N/g, K) (Table I lists
    # global GEMMs).  The all-gathered activation is the full (M, K).
    dev = gemm.device_gemm(g)
    mk_bytes = float(gemm.m * gemm.k) * b
    serial_comm = ineff.ag_serial_time(mk_bytes, machine)
    serial_gemm = ineff.gemm_exec(dev, machine).time

    if schedule is Schedule.SERIAL:
        # One AG, one GEMM, GEMM depends on the AG: the pipeline
        # recurrence reproduces total = serial_comm + serial_gemm with
        # the whole AG exposed.
        return ScheduleSteps(
            schedule, (serial_comm,), (serial_gemm,), (0,), 1,
            serial_comm, serial_gemm, comm_cil=1.0, gemm_cil=1.0,
        )

    if schedule is Schedule.SHARD_P2P:
        return _steps_shard_p2p(
            gemm, dev, machine, serial_comm, serial_gemm, dma
        )

    if profile is not None:
        return _steps_ficco_ragged(
            gemm, machine, schedule, profile, serial_comm, serial_gemm,
            dma, dma_into_place,
        )
    return _steps_ficco(
        gemm, dev, machine, schedule, serial_comm, serial_gemm, dma,
        dma_into_place,
    )


def _steps_shard_p2p(
    gemm: GemmShape,
    dev: GemmShape,
    machine: MachineSpec,
    serial_comm: float,
    serial_gemm: float,
    dma: bool,
) -> ScheduleSteps:
    g = machine.group
    shard = dev.shard(g, "m")
    shard_bytes = float(shard.m * shard.k) * gemm.dtype_bytes
    deg = 2  # comm + compute only
    c_cil = ineff.comm_cil(shard, machine, degree=deg, dma=dma)
    g_cil = ineff.gemm_cil(shard, machine, degree=deg, dma=dma)
    t_p2p = ineff.p2p_step_time(shard_bytes, machine) * c_cil
    t_gemm = ineff.gemm_exec(shard, machine).time * g_cil
    # compute_0 = local shard (no dep); compute_i needs P2P step i-1.
    comm = (t_p2p,) * (g - 1)
    compute = (t_gemm,) * g
    deps: tuple[int | None, ...] = (None, *range(g - 1))
    return ScheduleSteps(
        Schedule.SHARD_P2P, comm, compute, deps, g,
        serial_comm, serial_gemm,
        comm_cil=c_cil, gemm_cil=g_cil, local_first=True,
    )


def _steps_ficco(
    gemm: GemmShape,
    dev: GemmShape,
    machine: MachineSpec,
    schedule: Schedule,
    serial_comm: float,
    serial_gemm: float,
    dma: bool,
    dma_into_place: bool = False,
) -> ScheduleSteps:
    g = machine.group
    b = gemm.dtype_bytes
    var = schedule.variant
    m_s = dev.m // g  # shard rows

    if schedule is Schedule.UNIFORM_FUSED_2D:
        # chunks are (m_s, K/g); step GEMM is accumulating (M, N, K/g).
        chunk_bytes = float(m_s * (dev.k // g)) * b
        step_gemm = dev.shard(g, "k")
        gather_bytes = float(dev.m * (dev.k // g)) * b
        scatter_bytes = 0.0
        degree = 4  # comm + gather + compute + C accumulate traffic
        accumulate = True
        n_comm, n_comp = g, g
        local_first = None
        per_step_gemms = 1
    elif schedule is Schedule.UNIFORM_FUSED_1D:
        chunk_bytes = float((m_s // g) * dev.k) * b
        step_gemm = dev.shard(g, "m")
        gather_bytes = float(m_s * dev.k) * b
        scatter_bytes = float(m_s * dev.n) * b
        degree = 4  # comm + gather + compute + scatter
        accumulate = False
        n_comm, n_comp = g, g
        local_first = None
        per_step_gemms = 1
    elif schedule is Schedule.HETERO_FUSED_1D:
        chunk_bytes = float((m_s // g) * dev.k) * b
        rows = (g - 1) * (m_s // g)
        step_gemm = GemmShape(rows, dev.n, dev.k, b)
        gather_bytes = float(rows * dev.k) * b
        scatter_bytes = float(rows * dev.n) * b
        degree = 3  # gather is remote-only and smaller
        accumulate = False
        n_comm, n_comp = g, g
        local_first = dev.shard(g, "m")
        per_step_gemms = 1
    elif schedule is Schedule.HETERO_UNFUSED_1D:
        chunk_bytes = float((m_s // g) * dev.k) * b
        step_gemm = GemmShape(m_s // g, dev.n, dev.k, b)
        gather_bytes = 0.0  # computes directly on each received chunk
        scatter_bytes = float((g - 1) * (m_s // g) * dev.n) * b
        degree = 2  # comm + compute (scatter folded into epilogue)
        accumulate = False
        n_comm, n_comp = g, g
        local_first = dev.shard(g, "m")
        per_step_gemms = g - 1
    else:  # pragma: no cover
        raise ValueError(schedule)

    if dma_into_place:
        # fused kernel: no separate gather/scatter streams
        gather_bytes = 0.0
        scatter_bytes = 0.0
        degree = 2
    c_cil = ineff.comm_cil(dev.shard(g, "m"), machine, degree=degree, dma=dma)
    g_cil = ineff.gemm_cil(step_gemm, machine, degree=degree, dma=dma)

    t_comm = ineff.a2a_chunk_step_time(chunk_bytes, machine) * c_cil
    t_gemm_step = (
        per_step_gemms
        * ineff.gemm_exec(step_gemm, machine, accumulate=accumulate).time
        * g_cil
    )
    # Gather/Scatter are DMA streams concurrent with compute+comm (paper:
    # "uniform-fused-1D can execute communication, gather, compute, and
    # scatter at the same time") — their pressure is what raises the
    # schedule's concurrency degree / CIL; only residual non-hidden time
    # (when they exceed the GEMM) serializes.
    t_gather = ineff.hbm_move_time(gather_bytes, machine) if gather_bytes else 0.0
    t_scatter = (
        ineff.hbm_move_time(scatter_bytes, machine) if scatter_bytes else 0.0
    )
    t_step = max(t_gemm_step, t_gather + t_scatter)

    comm = (t_comm,) * n_comm
    if local_first is not None:
        t_local = (
            ineff.gemm_exec(local_first, machine).time
            * ineff.gemm_cil(local_first, machine, degree=degree, dma=dma)
        )
        compute: tuple[float, ...] = (t_local, *((t_step,) * n_comp))
        deps: tuple[int | None, ...] = (None, *range(n_comm))
    else:
        compute = (t_step,) * n_comp
        deps = tuple(range(n_comm))
    return ScheduleSteps(
        schedule, comm, compute, deps, n_comm, serial_comm, serial_gemm,
        comm_cil=c_cil, gemm_cil=g_cil,
        local_first=local_first is not None,
    )


def _steps_ficco_ragged(
    gemm: GemmShape,
    machine: MachineSpec,
    schedule: Schedule,
    profile: StepProfile,
    serial_comm: float,
    serial_gemm: float,
    dma: bool,
    dma_into_place: bool,
) -> ScheduleSteps:
    """Ragged FiCCO: per-step times from the shared step-time model
    (``batch.ragged_step_times`` with S == 1), scanned by the scalar
    masked pipeline.  Raises ValueError exactly where the batched
    engine's validity mask is False (indivisible M)."""
    import numpy as np  # local: the scalar core otherwise avoids numpy

    from repro_torch.core import batch as _batch  # local: avoids a cycle

    m = np.array([gemm.m], dtype=np.int64)
    n = np.array([gemm.n], dtype=np.int64)
    k = np.array([gemm.k], dtype=np.int64)
    b = np.array([gemm.dtype_bytes], dtype=np.int64)
    frac = np.array([profile.fractions], dtype=np.float64)
    comm_v, compute_v, deps, c_act, w_act, ok = _batch.ragged_step_times(
        m, n, k, b, frac, machine, schedule,
        dma=dma, dma_into_place=dma_into_place,
    )
    if not bool(ok[0]):
        raise ValueError(
            f"M={gemm.m} not divisible by group {machine.group} for "
            f"ragged {schedule}"
        )
    comm = tuple(float(c[0]) for c in comm_v)
    compute = tuple(float(w[0]) for w in compute_v)
    comm_active = tuple(bool(a[0]) for a in c_act)
    comp_active = tuple(bool(a[0]) for a in w_act)
    return ScheduleSteps(
        schedule, comm, compute, tuple(deps), profile.steps,
        serial_comm, serial_gemm,
        comm_active=comm_active, comp_active=comp_active,
        local_first=(
            schedule.variant.uniformity is _su.Uniformity.HETERO
        ),
    )


def best_schedule(
    gemm: GemmShape, machine: MachineSpec, *, dma: bool = True
) -> tuple[Schedule, dict[Schedule, SimResult]]:
    """Simulator-optimal schedule among the studied four + baselines."""
    from repro_torch.core.schedule_types import STUDIED

    results = {
        s: simulate(gemm, machine, s, dma=dma)
        for s in (Schedule.SERIAL, Schedule.SHARD_P2P, *STUDIED)
    }
    best = min(results, key=lambda s: results[s].total)
    return best, results
