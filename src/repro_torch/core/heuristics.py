"""FiCCO schedule-selection heuristics (paper Fig. 12a; port of
``repro.core.heuristics``).

The decision tree uses only *static* GEMM parameters so frameworks/runtimes
can pick a bespoke schedule without profiling:

  1. Communication shape: 1D if M > K else 2D — minimizes the dominant DIL
     direction (row-sharding hurts when M < K, §IV-C1).  2D has a single
     studied schedule: uniform-fused-2D.
  2. Within 1D, compare the combined OTB x MT metric (note OTB * MT_bytes
     == 2*M*N*K == the GEMM's FLOPs) against a machine-level threshold
     derived from peak compute (op-to-byte x memory bandwidth = FLOPs,
     scaled by a one-time-tuned horizon TAU):

        metric <  T        -> uniform-fused-1D   (low DIL / high CIL)
        metric >= 5 * T    -> hetero-unfused-1D  (high DIL / low CIL)
        otherwise          -> hetero-fused-1D    (balanced)

TAU is the paper's "one-time tuning cost for thresholds" (§VIII-C); it is
fit once per machine in ``calibrate_tau`` against the simulator
(:mod:`repro_torch.core.simulator`, through the grid engines) and then
frozen (default below was frozen for MI300X).

Beyond the paper, the tree carries a **serial gate** learned from the
design-space grid: the paper's tree always decomposes, but at grid
scale ~65% of (scenario, machine) points have a *serial* analytic
optimum — comm-bound operators whose finer-grain exchange inflates the
dominant communication stream (per-chunk latency + ramp, comm CIL) by
more than the compute it hides.  The static signal is

    score = r * (inflate * CIL - 1),   r = T_comm / T_gemm (roofline),
    inflate = chunked/serial all-gather time from the link model,

"serial wins" iff the inflated comm overhead exceeds the hidden compute,
i.e. score > gate with gate ~= 1 (the frozen default is calibrated on
the grid, see ``calibrate_serial_gate``).  A sweep-learned gate family
(``gate=``, :class:`repro_torch.learn.gate.LearnedGate`) replaces the
scalar threshold with one conditioned on the profile's skew.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.machine import MachineSpec
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import GemmShape

# One-time tuned horizon (seconds of peak compute) per machine family —
# frozen after calibration against the schedule simulator (paper §VIII-C:
# thresholds carry a one-time tuning cost per machine).  The port has that
# simulator, so ``calibrate_tau`` re-derives it for any machine.
DEFAULT_TAU = 0.02
_TAU_OVERRIDES: dict[str, float] = {}

# Beyond-paper guard: operators too small to amortize even one extra kernel
# launch per chunk are left serial (the paper's scenarios never hit this; our
# smoke-scale models do).
MIN_DECOMPOSE_FLOPS = 1.0e9

# Serial/overlap gate (see module docstring): stay serial when
# ``serial_gate_score > gate``.  The theory-derived breakeven is 1.0;
# the frozen default is calibrated on the scenario-grid x
# machine-grid sweep, constrained to keep the paper-fidelity sets
# (Table I + 16 synthetic, MI300X) at their pre-gate accuracy.
DEFAULT_SERIAL_GATE = 1.2
_SERIAL_GATE_OVERRIDES: dict[str, float] = {}
# FiCCO comm CIL geomean (paper §IV-D) used inside the gate score.
_GATE_COMM_CIL = 1.12


def machine_serial_gate(machine: MachineSpec) -> float:
    """The hand-tuned scalar gate threshold for a machine.

    This is the *scalar* end of the gate resolution:
    ``select_schedule`` consults a learned per-machine-family gate
    (:func:`repro_torch.learn.gate.set_machine_gate`) ahead of this value —
    see :func:`_family_gate` — so this threshold applies only when no
    learned family covers the machine.
    """
    return _SERIAL_GATE_OVERRIDES.get(machine.name, DEFAULT_SERIAL_GATE)


def _family_gate(machine: MachineSpec):
    """Learned family gate for a machine, or None.

    Soft lookup through ``sys.modules``: the core package never imports
    :mod:`repro_torch.learn` (which would drag the training stack into
    every import of the core), so family gates only steer decisions in
    processes that already loaded the learn package and registered one.
    """
    import sys

    mod = sys.modules.get("repro_torch.learn.gate")
    if mod is None:
        return None
    try:
        return mod.get_machine_gate(machine)
    except Exception:
        return None


def serial_gate_terms_batch(m, n, k, dtype_bytes, machine: MachineSpec):
    """Vectorized ``(r, inflate)`` terms of the serial-gate score.

    All quantities are static machine-model numbers (no profiling):
    ``r`` compares the serial all-gather against the peak-rate
    per-device GEMM; ``inflate`` is the chunked/serial all-gather time
    ratio from the shared link model (g FiCCO steps of 1/g^2-sized
    chunks vs one serial all-gather — both via the same
    ``repro_torch.core.batch`` formulas the engines use, so a comm-model fix
    propagates here automatically).  ``repro_torch.learn.features`` reuses
    these terms as learned-gate inputs, so the heuristic and the
    learner can never drift apart on their definitions.
    """
    from repro_torch.core import batch as _batch  # local: avoids a cycle

    m = np.asarray(m, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    b = np.asarray(dtype_bytes, dtype=np.float64)
    g = machine.group
    dev_n = np.where(n % g == 0, n / g, n)
    mk_bytes = m * k * b
    t_comm = mk_bytes / machine.ag_bw
    t_gemm = 2.0 * m * dev_n * k / machine.peak_flops
    with np.errstate(divide="ignore", invalid="ignore"):
        r = t_comm / t_gemm
        t_serial_ag = _batch.ag_serial_time_vec(mk_bytes, machine)
        t_chunked_ag = g * _batch.a2a_chunk_step_time_vec(
            mk_bytes / (g * g), machine
        )
        inflate = t_chunked_ag / t_serial_ag
    return r, inflate


def serial_gate_score_from_terms(r, inflate):
    """Gate score from precomputed :func:`serial_gate_terms_batch` terms
    (lets callers that also need the terms compute them once)."""
    with np.errstate(invalid="ignore"):
        return r * (inflate * _GATE_COMM_CIL - 1.0)


def serial_gate_score_batch(m, n, k, dtype_bytes, machine: MachineSpec):
    """Vectorized gate score: comm/compute ratio x net chunking overhead.

    Overlap can hide at most the GEMM; chunking costs
    ``(inflate * CIL - 1)`` of the comm — serial wins when the latter
    (scaled by r) exceeds 1.  See :func:`serial_gate_terms_batch` for
    the two terms.
    """
    return serial_gate_score_from_terms(
        *serial_gate_terms_batch(m, n, k, dtype_bytes, machine)
    )


def serial_gate_score(gemm: GemmShape, machine: MachineSpec) -> float:
    return float(
        serial_gate_score_batch(
            gemm.m, gemm.n, gemm.k, gemm.dtype_bytes, machine
        )
    )


def calibrate_serial_gate(
    machines,
    scenarios,
    candidates=(0.3, 0.5, 0.7, 0.9, 1.0, 1.2, 1.5, 2.0, 3.0),
    *,
    freeze: bool = False,
    backend: str = "numpy",
) -> float:
    """Learn the serial/overlap gate from a grid: pick the candidate that
    maximizes grid-wide within-5% accuracy of the gated heuristic.

    One batched sweep supplies the analytic optima; every candidate is a
    vectorized re-gating.  ``freeze=True`` records the winner as a
    per-machine override for each machine in ``machines``.  ``backend``
    names any registered engine (``repro_torch.core.engine``).
    """
    from repro_torch.core import batch as _batch  # local: avoids a cycle
    from repro_torch.core.engine import get_engine

    machines = tuple(machines)
    sb = _batch.ScenarioBatch.from_scenarios(scenarios)
    grid = get_engine(backend).evaluate(sb, machines)
    best_total = grid.best_total()
    s_idx = np.arange(len(sb))[:, None]
    m_idx = np.arange(len(machines))[None, :]
    base_picks = np.stack(
        [
            select_schedule_batch(
                sb.m, sb.n, sb.k, sb.dtype_bytes, mach, serial_gate=np.inf
            )
            for mach in machines
        ],
        axis=1,
    )
    scores = np.stack(
        [
            serial_gate_score_batch(sb.m, sb.n, sb.k, sb.dtype_bytes, mach)
            for mach in machines
        ],
        axis=1,
    )
    serial_l = _batch.SCHEDULE_INDEX[Schedule.SERIAL]

    best_gate, best_acc = candidates[0], -1.0
    for gate in candidates:
        picks = np.where(scores > gate, serial_l, base_picks)
        t = grid.total[picks, s_idx, m_idx]
        acc = float(
            np.mean(np.nan_to_num(t, nan=np.inf) <= 1.05 * best_total)
        )
        if acc > best_acc:
            best_gate, best_acc = gate, acc
    if freeze:
        for mach in machines:
            _SERIAL_GATE_OVERRIDES[mach.name] = best_gate
    return best_gate


@dataclasses.dataclass(frozen=True)
class HeuristicDecision:
    schedule: Schedule
    metric: float  # OTB x MT == GEMM FLOPs
    threshold: float
    reason: str


def machine_threshold(machine: MachineSpec, tau: float | None = None) -> float:
    """T = peak FLOP/s x TAU: 'op-to-byte x memory bandwidth = FLOPs'."""
    if tau is None:
        tau = _TAU_OVERRIDES.get(machine.name, DEFAULT_TAU)
    return machine.peak_flops * tau


def select_schedule(
    gemm: GemmShape,
    machine: MachineSpec,
    *,
    tau: float | None = None,
    allow_serial_guard: bool = True,
    serial_gate: float | None = None,
    profile=None,
    gate=None,
) -> HeuristicDecision:
    """Static schedule pick (Fig. 12a tree + the learned serial gate).

    ``serial_gate`` overrides the calibrated gate threshold; pass
    ``float("inf")`` to disable the gate (the paper's original tree).
    The gate only applies when ``allow_serial_guard`` is True — both are
    "stay serial" escapes the paper does not model.

    ``profile`` (a :class:`~repro_torch.core.workload.StepProfile`) makes the
    gate **skew-aware**: a ragged decomposition's largest chunk sets the
    pipeline's critical step, so the chunking-overhead score is scaled
    by the profile's imbalance (max/mean active-step share) — heavily
    skewed EP dispatches fall back to serial sooner, which is exactly
    what the ragged grid's analytic optima show.

    ``gate`` (a :class:`repro_torch.learn.gate.LearnedGate`) replaces the
    scalar threshold with the sweep-learned threshold *family*: the raw
    gate score is compared against a per-scenario threshold conditioned
    on ``(imbalance, active_steps, OTB, r)`` — the profile's skew enters
    as a tree feature rather than a fixed multiplicative scaling.  It
    takes precedence over both the calibrated per-machine gate and an
    explicit ``serial_gate`` float.
    """
    metric = gemm.otb * gemm.bytes_mt  # == gemm.flops
    t = machine_threshold(machine, tau)

    if allow_serial_guard and gemm.flops < MIN_DECOMPOSE_FLOPS:
        return HeuristicDecision(
            Schedule.SERIAL, metric, t,
            "operator too small to amortize decomposition (beyond-paper guard)",
        )
    if allow_serial_guard:
        score = serial_gate_score(gemm, machine)
        if gate is None and serial_gate is None:
            # Neither an explicit learned gate nor an explicit scalar:
            # a registered per-machine-family gate outranks the
            # hand-tuned scalar below.
            gate = _family_gate(machine)
        if gate is not None:
            # ``>=`` matches the learned gate's training accounting
            # (score bins are right-closed at the threshold edges).
            thr = float(gate.threshold_for(gemm, machine, profile=profile))
            stay_serial = score >= thr
            reason = (
                "comm-bound: chunking overhead exceeds hidden compute "
                "(sweep-learned gate family)"
            )
        else:
            g_thr = (
                serial_gate
                if serial_gate is not None
                else machine_serial_gate(machine)
            )
            imbalance = 1.0 if profile is None else float(profile.imbalance)
            stay_serial = score * imbalance > g_thr
            reason = (
                "comm-bound: chunking overhead exceeds hidden compute "
                "(grid-learned serial gate)"
            )
        if stay_serial:
            return HeuristicDecision(Schedule.SERIAL, metric, t, reason)
    if gemm.m < gemm.k:
        return HeuristicDecision(
            Schedule.UNIFORM_FUSED_2D, metric, t,
            "M < K: row-sharding suboptimal -> 2D (column) communication",
        )
    if metric < t:
        return HeuristicDecision(
            Schedule.UNIFORM_FUSED_1D, metric, t,
            "OTBxMT below machine threshold: DIL-sensitive, CIL-tolerant",
        )
    if metric >= 5.0 * t:
        return HeuristicDecision(
            Schedule.HETERO_UNFUSED_1D, metric, t,
            "OTBxMT >= 5x threshold: CIL-sensitive, DIL-tolerant",
        )
    return HeuristicDecision(
        Schedule.HETERO_FUSED_1D, metric, t,
        "OTBxMT in middle tranche: balanced signature",
    )


def select_schedule_batch(
    m,
    n,
    k,
    dtype_bytes,
    machine: MachineSpec,
    *,
    tau: float | None = None,
    allow_serial_guard: bool = True,
    serial_gate: float | None = None,
    imbalance=None,
    active_steps=None,
    gate=None,
    terms=None,
):
    """Vectorized :func:`select_schedule` over ``(S,)`` shape arrays.

    Returns an int array of indices into
    ``repro_torch.core.batch.GRID_SCHEDULES`` (the same order the batched
    simulator uses), replicating the scalar decision tree branch for
    branch.

    ``imbalance`` is the per-scenario ragged-profile imbalance factor
    (``RaggedBatch.imbalance``; 1.0 == uniform): it scales the serial
    gate score exactly like the scalar tree's ``profile`` argument.

    ``gate`` (a :class:`repro_torch.learn.gate.LearnedGate`) swaps the
    scalar gate for the learned threshold family, exactly like the scalar
    tree's ``gate`` argument; ``active_steps`` (per-scenario active step
    counts, default ``machine.group``) is a gate feature alongside
    ``imbalance``.  ``terms`` optionally carries precomputed
    :func:`serial_gate_terms_batch` output so batch callers evaluate the
    link model exactly once.
    """
    from repro_torch.core.batch import SCHEDULE_INDEX  # local: avoids a cycle

    m = np.asarray(m)
    n = np.asarray(n)
    k = np.asarray(k)
    b = np.asarray(dtype_bytes)
    flops = 2.0 * m * n * k
    bytes_mt = (m * k + k * n + m * n).astype(np.float64) * b
    metric = (flops / bytes_mt) * bytes_mt  # == flops, scalar-model order
    t = machine_threshold(machine, tau)

    if allow_serial_guard:
        if terms is None:
            terms = serial_gate_terms_batch(m, n, k, b, machine)
        scores = serial_gate_score_from_terms(*terms)
        if gate is None and serial_gate is None:
            # Same family-gate precedence as the scalar tree.
            gate = _family_gate(machine)
        if gate is not None:
            # ``>=`` matches the learned gate's training accounting.
            # The precomputed terms ride along so the gate's feature
            # matrix does not recompute the link model.
            thr = gate.thresholds_batch(
                m, n, k, b, machine,
                imbalance=imbalance, active_steps=active_steps,
                terms=terms,
            )
            stay_serial = (flops < MIN_DECOMPOSE_FLOPS) | (scores >= thr)
        else:
            g_thr = (
                serial_gate
                if serial_gate is not None
                else machine_serial_gate(machine)
            )
            imb = (
                1.0 if imbalance is None
                else np.asarray(imbalance, np.float64)
            )
            stay_serial = (flops < MIN_DECOMPOSE_FLOPS) | (
                scores * imb > g_thr
            )
    else:
        stay_serial = np.zeros(m.shape, dtype=bool)
    conds = [
        stay_serial,
        m < k,
        metric < t,
        metric >= 5.0 * t,
    ]
    choices = [
        SCHEDULE_INDEX[Schedule.SERIAL],
        SCHEDULE_INDEX[Schedule.UNIFORM_FUSED_2D],
        SCHEDULE_INDEX[Schedule.UNIFORM_FUSED_1D],
        SCHEDULE_INDEX[Schedule.HETERO_UNFUSED_1D],
    ]
    return np.select(conds, choices, SCHEDULE_INDEX[Schedule.HETERO_FUSED_1D])


def calibrate_tau(
    machine: MachineSpec,
    scenarios,
    candidates=(0.02, 0.05, 0.1, 0.2, 0.5, 1.0),
    *,
    backend: str = "numpy",
) -> float:
    """One-time TAU fit: maximize agreement with the simulator-optimal
    schedule over a calibration set (paper tunes thresholds per machine).

    Runs as one batched sweep: the simulator-optimal schedules come from
    a single engine evaluation (``backend`` names any registered engine)
    and each TAU candidate is a vectorized re-threshold — no
    per-(tau, scenario) scalar simulation.
    """
    from repro_torch.core import batch as _batch  # local: avoids a cycle
    from repro_torch.core.engine import get_engine

    sb = _batch.ScenarioBatch.from_scenarios(scenarios)
    grid = get_engine(backend).evaluate(sb, (machine,))
    best = grid.best_idx()[:, 0]

    best_tau, best_acc = candidates[0], -1.0
    for tau in candidates:
        picks = select_schedule_batch(
            sb.m, sb.n, sb.k, sb.dtype_bytes, machine, tau=tau
        )
        acc = float(np.mean(picks == best))
        if acc > best_acc:
            best_tau, best_acc = tau, acc
    _TAU_OVERRIDES[machine.name] = best_tau
    return best_tau
