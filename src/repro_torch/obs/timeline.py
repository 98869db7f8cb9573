"""Schedule-timeline + inefficiency-signature exporter.

Port of ``repro.obs.timeline`` (a copy).

Renders any simulated schedule — a ``(gemm, machine, schedule)`` triple,
or one entry of a :class:`~repro_torch.core.engine.GridResult` — as a
per-step comm/GEMM/DMA lane timeline in the same Chrome trace-event format the
runtime tracer (:mod:`repro_torch.obs.trace`) emits, annotated with the
paper's inefficiency decomposition (exposure, decomposition overhead,
contention) from :mod:`repro_torch.core.inefficiency`.  This is the paper's
per-schedule Gantt figures (Fig. 6 / Fig. 11b) reproduced as a tool:
every FiCCO schedule in the design space opens in ``chrome://tracing``
or https://ui.perfetto.dev.

Lanes (threads under one process per rendered scenario):

  tid 0  comm (DMA)      — AG / P2P / per-chunk A2A steps
  tid 1  compute (GEMM)  — local-shard + per-step GEMMs (incl. the
                           gather/scatter residual folded into a step)
  tid 2  exposed comm    — intervals where compute stalls on the wire

The lowering comes from :func:`repro_torch.core.simulator.schedule_steps`, so
what the timeline shows is *exactly* what ``simulate()`` integrates —
the rendered spans sum to ``SimResult.comm_busy``/``compute_busy`` and
the stall lane to ``SimResult.exposed_comm``.
"""

from __future__ import annotations

from repro_torch.obs import trace as _trace

_LANE_COMM, _LANE_COMPUTE, _LANE_EXPOSED = 0, 1, 2


def lane_intervals(steps) -> dict:
    """Per-step ``(start_s, duration_s)`` intervals for each lane.

    Replays the simulator's pipeline recurrence (masked form — the
    unmasked queues are the all-active special case) keeping start
    times instead of only the final clock.  Inactive (ragged-padding)
    steps are dropped from the output rather than rendered as
    zero-width spans.
    """
    comm_active = steps.comm_active or (True,) * len(steps.comm)
    comp_active = steps.comp_active or (True,) * len(steps.compute)

    comm_iv: list[tuple[float, float]] = []
    finish: list[float] = []
    t = 0.0
    for c, active in zip(steps.comm, comm_active):
        dur = c if active else 0.0
        if active:
            comm_iv.append((t, dur))
        t += dur
        finish.append(t)

    comp_iv: list[tuple[float, float]] = []
    stall_iv: list[tuple[float, float]] = []
    t_comp = 0.0
    for i, work in enumerate(steps.compute):
        active = comp_active[i]
        w = work if active else 0.0
        dep = steps.deps[i]
        if dep is not None and active:
            ready = finish[dep]
            if ready > t_comp:
                stall_iv.append((t_comp, ready - t_comp))
                t_comp = ready
        if active:
            comp_iv.append((t_comp, w))
        t_comp += w
    return {"comm": comm_iv, "compute": comp_iv, "exposed": stall_iv}


def inefficiency_signature(steps, result=None) -> dict:
    """The schedule's inefficiency decomposition, in seconds.

    Splits the gap between the ideal overlap time and the simulated
    total into the paper's §IV loss categories, inverted from the
    streams' aggregate busy times and the CIL factors the lowering
    applied:

      exposure_s             comm the compute channel actually waited on
      comm_decomposition_s   finer-grain DMA overhead (latency + ramp
                             per chunk; link under-use for shard-P2P):
                             busy/cil − serial
      comm_contention_s      slowdown from concurrent streams:
                             busy · (1 − 1/cil)
      gemm_decomposition_s / gemm_contention_s — same split for compute
                             (decomposition = DIL: re-reads, occupancy,
                             launch latency of the chunked GEMMs)

    The contention split needs the scalar CIL factors the uniform
    lowering records; ragged lowerings apply CIL per step internally,
    so only the always-valid fields are reported there.  The hetero
    local-shard GEMM runs under the step streams' CIL factor
    approximately (its own factor differs by chunk shape), making the
    hetero splits a close decomposition, not an exact one.
    """
    res = result if result is not None else steps.run()
    sig = {
        "schedule": res.schedule.value,
        "steps": res.steps,
        "total_s": res.total,
        "serial_comm_s": res.serial_comm,
        "serial_gemm_s": res.serial_gemm,
        "serial_total_s": res.serial_total,
        "ideal_total_s": res.ideal_total,
        "speedup": res.speedup,
        "exposure_s": res.exposed_comm,
        "comm_busy_s": res.comm_busy,
        "compute_busy_s": res.compute_busy,
    }
    if steps.comm_cil is not None and steps.gemm_cil is not None:
        cc, gc = steps.comm_cil, steps.gemm_cil
        sig.update(
            comm_cil=cc,
            gemm_cil=gc,
            comm_contention_s=res.comm_busy * (1.0 - 1.0 / cc),
            comm_decomposition_s=res.comm_busy / cc - res.serial_comm,
            gemm_contention_s=res.compute_busy * (1.0 - 1.0 / gc),
            gemm_decomposition_s=res.compute_busy / gc - res.serial_gemm,
        )
    return sig


def _comm_step_name(schedule) -> str:
    from repro_torch.core.schedule_types import Schedule

    return {
        Schedule.SERIAL: "all_gather",
        Schedule.SHARD_P2P: "p2p_step",
    }.get(schedule, "a2a_chunk")


def schedule_timeline(
    gemm,
    machine,
    schedule,
    *,
    dma: bool = True,
    dma_into_place: bool = False,
    profile=None,
    tracer=None,
    pid: int = 1,
    name: str | None = None,
):
    """Render one scenario's schedule into a tracer.

    Returns ``(tracer, signature)``; pass an existing ``tracer`` (and
    distinct ``pid``\\ s) to stack several scenarios/schedules in one
    trace for side-by-side comparison in Perfetto.  Raises ValueError
    exactly where ``simulate`` does (indivisible decompositions).
    """
    from repro_torch.core.simulator import schedule_steps

    steps = schedule_steps(
        gemm, machine, schedule,
        dma=dma, dma_into_place=dma_into_place, profile=profile,
    )
    res = steps.run()
    sig = inefficiency_signature(steps, res)
    lanes = lane_intervals(steps)

    tr = tracer if tracer is not None else _trace.Tracer()
    label = name or f"m{gemm.m} n{gemm.n} k{gemm.k}"
    tr.name_process(pid, f"{label} | {schedule.value} @ {machine.name}")
    tr.name_thread(pid, _LANE_COMM, "comm (DMA)")
    tr.name_thread(pid, _LANE_COMPUTE, "compute (GEMM)")
    tr.name_thread(pid, _LANE_EXPOSED, "exposed comm (stall)")

    comm_name = _comm_step_name(schedule)
    for i, (t0, dur) in enumerate(lanes["comm"]):
        tr._append({
            "name": comm_name, "cat": "timeline/comm", "ph": "X",
            "ts": t0 * 1e6, "dur": dur * 1e6,
            "pid": pid, "tid": _LANE_COMM,
            "args": {"step": i, "seconds": dur},
        })
    for i, (t0, dur) in enumerate(lanes["compute"]):
        is_local = steps.local_first and i == 0
        tr._append({
            "name": "local_gemm" if is_local else "gemm_step",
            "cat": "timeline/compute", "ph": "X",
            "ts": t0 * 1e6, "dur": dur * 1e6,
            "pid": pid, "tid": _LANE_COMPUTE,
            "args": {"step": i, "seconds": dur},
        })
    for i, (t0, dur) in enumerate(lanes["exposed"]):
        tr._append({
            "name": "exposed", "cat": "timeline/exposed", "ph": "X",
            "ts": t0 * 1e6, "dur": dur * 1e6,
            "pid": pid, "tid": _LANE_EXPOSED,
            "args": {"seconds": dur},
        })
    tr._append({
        "name": "inefficiency_signature", "cat": "timeline", "ph": "i",
        "ts": 0.0, "s": "p", "pid": pid, "tid": _LANE_COMM, "args": sig,
    })
    return tr, sig


def grid_timeline(
    grid,
    scenario: int,
    machine: int = 0,
    *,
    schedule=None,
    tracer=None,
    pid: int = 1,
    name: str | None = None,
):
    """Render one ``GridResult`` entry (default: its best schedule).

    Re-lowers the scenario through the scalar simulator — bit-identical
    to the grid's own figures by the engine differential contract — so
    any sweep point can be pulled out of a result table and *looked at*.
    """
    from repro_torch.core import batch as _batch
    from repro_torch.core.workload import StepProfile

    if schedule is None:
        schedule = grid.schedules[int(grid.best_idx()[scenario, machine])]
    profile = None
    if isinstance(grid.scenarios, _batch.RaggedBatch):
        profile = StepProfile.from_weights(
            grid.scenarios.frac[scenario]
        ).trimmed()
    return schedule_timeline(
        grid.scenarios.gemm(scenario),
        grid.machines[machine],
        schedule,
        dma=grid.dma,
        profile=profile,
        tracer=tracer,
        pid=pid,
        name=name or f"scenario {scenario}",
    )


__all__ = [
    "lane_intervals",
    "inefficiency_signature",
    "schedule_timeline",
    "grid_timeline",
]
