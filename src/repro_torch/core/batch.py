"""Vectorized batched design-space engine (port of ``repro.core.batch``).

The scalar simulator (``repro_torch.core.simulator``) walks one ``(scenario,
machine, schedule)`` triple at a time in Python — fine for the 16 Table-I
rows, hopeless for design-space sweeps over every registry architecture x
dtype x group size x topology.  This module evaluates the *whole grid* in
NumPy array math:

  * the roofline GEMM model (:func:`gemm_exec_vec`): tiles, split-K,
    occupancy, reduction ramp — all elementwise over ``(S,)`` shape arrays;
  * the communication model (:func:`ag_serial_time_vec`,
    :func:`a2a_chunk_step_time_vec`, :func:`p2p_step_time_vec`);
  * the CIL interference formulas (:func:`gemm_cil_vec`,
    :func:`comm_cil_vec`), reusing the machine-level calibrated
    coefficients from ``repro_torch.core.inefficiency`` (cached, bisected once);
  * the two-channel pipeline recurrence (:func:`pipeline_vec`): a scan
    over the uniform step lists — ``group`` iterations of ``(S,)`` array
    ops, replicating the scalar accumulation order *bit for bit* so
    batched totals match ``simulate()`` exactly, ties included.

Quick start (the whole grid in three lines)::

    from repro_torch.core import MI300X, TABLE_I, explore_grid
    ex = explore_grid(TABLE_I, machines=[MI300X])
    print(ex.summary())          # accuracy / speedups over S x M x schedules

Machines are looped (there are a handful), scenarios are vectorized
(there are thousands) — the Python-level work is ``O(M x schedules x
group)`` regardless of S.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import inefficiency as ineff
from repro_torch.core.engine import (  # canonical home: repro_torch.core.engine
    GRID_SCHEDULES,
    SCHEDULE_INDEX,
    GridResult,
)
from repro_torch.core.machine import MachineSpec, Topology
from repro_torch.core.schedule_types import STUDIED, Schedule
from repro_torch.core.workload import (
    GemmShape,
    RaggedScenario,
    Scenario,
    StepProfile,
)

_F = np.float64


# ---------------------------------------------------------------------------
# Scenario batches.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioBatch:
    """Struct-of-arrays view of S global GEMM scenarios."""

    m: np.ndarray  # (S,) int64
    n: np.ndarray  # (S,) int64
    k: np.ndarray  # (S,) int64
    dtype_bytes: np.ndarray  # (S,) int64
    names: tuple[str, ...] = ()

    def __post_init__(self):
        for f in ("m", "n", "k", "dtype_bytes"):
            a = getattr(self, f)
            if a.ndim != 1 or a.shape != self.m.shape:
                raise ValueError(f"{f} must be 1-D and congruent, got {a.shape}")

    def __len__(self) -> int:
        return self.m.shape[0]

    @classmethod
    def from_gemms(cls, gemms, names=()) -> "ScenarioBatch":
        gemms = list(gemms)
        return cls(
            m=np.array([g.m for g in gemms], dtype=np.int64),
            n=np.array([g.n for g in gemms], dtype=np.int64),
            k=np.array([g.k for g in gemms], dtype=np.int64),
            dtype_bytes=np.array(
                [g.dtype_bytes for g in gemms], dtype=np.int64
            ),
            names=tuple(names),
        )

    @classmethod
    def from_scenarios(cls, scenarios) -> "ScenarioBatch":
        scenarios = list(scenarios)
        return cls.from_gemms(
            (s.gemm for s in scenarios), names=tuple(s.name for s in scenarios)
        )

    def gemm(self, i: int) -> GemmShape:
        return GemmShape(
            int(self.m[i]), int(self.n[i]), int(self.k[i]),
            int(self.dtype_bytes[i]),
        )


def _as_batch(scenarios) -> ScenarioBatch:
    if isinstance(scenarios, ScenarioBatch):
        return scenarios
    scenarios = list(scenarios)
    if scenarios and isinstance(scenarios[0], (Scenario, RaggedScenario)):
        return ScenarioBatch.from_scenarios(scenarios)
    return ScenarioBatch.from_gemms(scenarios)


@dataclasses.dataclass(frozen=True)
class RaggedBatch(ScenarioBatch):
    """Struct-of-arrays view of S *ragged* scenarios.

    ``frac`` is the ``(S, P)`` padded per-step fraction matrix (rows sum
    to 1; zero entries are masked tail / empty steps).  Mixed profile
    lengths batch together by zero-padding to the longest profile —
    the masked scan charges padded steps exactly nothing.
    """

    frac: np.ndarray = None  # (S, P) float64

    def __post_init__(self):
        super().__post_init__()
        if self.frac is None:
            raise ValueError("RaggedBatch requires a frac matrix")
        if self.frac.ndim != 2 or self.frac.shape[0] != self.m.shape[0]:
            raise ValueError(
                f"frac must be (S, P) with S={self.m.shape[0]}, "
                f"got {self.frac.shape}"
            )

    @property
    def max_steps(self) -> int:
        return self.frac.shape[1]

    @property
    def imbalance(self) -> np.ndarray:
        """(S,) max/mean active-step share (1.0 == uniform)."""
        active = self.frac > 0.0
        return self.frac.max(axis=1) * active.sum(axis=1)

    @property
    def active_steps(self) -> np.ndarray:
        """(S,) count of non-empty pipeline steps (float64).

        The single source of the "active" convention (strictly positive
        share) — the explorer's skew-aware gate features and
        ``repro_torch.learn.features`` both read this, so the training
        features and the applied features cannot drift apart.
        """
        return (self.frac > 0.0).sum(axis=1).astype(np.float64)

    def profile(self, i: int) -> StepProfile:
        return StepProfile(tuple(float(f) for f in self.frac[i])).trimmed()

    @classmethod
    def from_ragged_scenarios(cls, scenarios) -> "RaggedBatch":
        scenarios = list(scenarios)
        p_max = max(s.profile.steps for s in scenarios)
        frac = np.zeros((len(scenarios), p_max), dtype=_F)
        for i, s in enumerate(scenarios):
            frac[i, : s.profile.steps] = s.profile.fractions
        base = ScenarioBatch.from_scenarios(scenarios)
        return cls(
            m=base.m, n=base.n, k=base.k, dtype_bytes=base.dtype_bytes,
            names=base.names, frac=frac,
        )

    @classmethod
    def from_batch_and_profiles(cls, sb: ScenarioBatch, profiles) -> "RaggedBatch":
        profiles = list(profiles)
        if len(profiles) != len(sb):
            raise ValueError(
                f"{len(profiles)} profiles for {len(sb)} scenarios"
            )
        p_max = max(p.steps for p in profiles)
        frac = np.zeros((len(sb), p_max), dtype=_F)
        for i, p in enumerate(profiles):
            frac[i, : p.steps] = p.fractions
        return cls(
            m=sb.m, n=sb.n, k=sb.k, dtype_bytes=sb.dtype_bytes,
            names=sb.names, frac=frac,
        )


def _as_ragged_batch(scenarios) -> RaggedBatch:
    if isinstance(scenarios, RaggedBatch):
        return scenarios
    scenarios = list(scenarios)
    if not (scenarios and isinstance(scenarios[0], RaggedScenario)):
        raise TypeError(
            "ragged evaluation needs RaggedScenario items or a RaggedBatch"
        )
    return RaggedBatch.from_ragged_scenarios(scenarios)


# ---------------------------------------------------------------------------
# Vectorized roofline GEMM model (mirror of inefficiency.gemm_exec).
# ---------------------------------------------------------------------------


def gemm_exec_vec(
    m: np.ndarray,
    n: np.ndarray,
    k: np.ndarray,
    b: np.ndarray,
    machine: MachineSpec,
    *,
    accumulate: bool = False,
) -> np.ndarray:
    """Elementwise ``inefficiency.gemm_exec(...).time`` over shape arrays.

    Every operation replicates the scalar model's expression order so the
    results agree to the last ulp.  Lanes with ``m == 0`` (degenerate
    decompositions the scalar model would reject) yield NaN.
    """
    t_mn, pu = machine.tile_mn, machine.parallel_units
    # Clamp to >= 1 tile: ragged profiles can produce sub-row fractional
    # chunks whose floor-div would yield 0 tiles (0/0 occupancy).  A
    # no-op for integer m, n >= 1, so the uniform grid is untouched.
    cm = np.maximum((m + t_mn - 1) // t_mn, 1)
    cn = np.maximum((n + t_mn - 1) // t_mn, 1)
    tiles = cm * cn
    split_cap = np.where(m <= t_mn, 2, 8)
    ceil_pu = (pu + tiles - 1) // np.maximum(tiles, 1)
    splits = np.minimum(
        np.minimum(ceil_pu, np.maximum(k // machine.tile_k, 1)), split_cap
    )
    splits = np.where(tiles < pu, splits, 1)
    work = tiles * splits
    padded_flops = 2.0 * (cm * t_mn) * (cn * t_mn) * k
    with np.errstate(divide="ignore", invalid="ignore"):
        occ_quant = work / (-(-work // pu) * pu)
        occ_smooth = np.minimum(1.0, work / pu)
        occupancy = 0.5 * (occ_quant + occ_smooth)
        k_eff = k / (k + machine.tile_k)
        compute = (
            padded_flops
            / machine.peak_flops
            / np.maximum(occupancy * k_eff, 1e-9)
        )
        bytes_hbm = (m * k + k * n + m * n).astype(_F) * b
        if accumulate:
            bytes_hbm = bytes_hbm + (m * n).astype(_F) * b
        bytes_hbm = bytes_hbm + np.where(
            splits > 1, 2.0 * (splits - 1) * (m * n).astype(_F) * 4, 0.0
        )
        memory = bytes_hbm / machine.hbm_bw
        base = np.maximum(compute, memory)
        ramp = machine.kernel_ramp
        t = machine.kernel_latency + base * (1.0 + ramp / (base + ramp))
    return np.where(m > 0, t, np.nan)


# ---------------------------------------------------------------------------
# Vectorized communication model.
# ---------------------------------------------------------------------------


def comm_time_vec(
    nbytes_per_link: np.ndarray,
    machine: MachineSpec,
    *,
    s_half: float,
    n_transfers: int = 1,
) -> np.ndarray:
    per = nbytes_per_link / max(n_transfers, 1)
    t_one = machine.link_latency + (per + s_half) / machine.link_bw
    return n_transfers * t_one


def ag_serial_time_vec(
    mk_bytes: np.ndarray, machine: MachineSpec
) -> np.ndarray:
    g = machine.group
    if machine.topology is Topology.FULL_MESH:
        per_link = mk_bytes / g
    else:
        per_link = mk_bytes * (g - 1) / g / machine.a2a_links
    return comm_time_vec(
        per_link, machine, s_half=ineff.calibrated_s_half(machine)
    )


def p2p_step_time_vec(
    shard_bytes: np.ndarray, machine: MachineSpec
) -> np.ndarray:
    return comm_time_vec(
        shard_bytes / machine.p2p_links,
        machine,
        s_half=ineff.calibrated_s_half(machine),
    )


def a2a_chunk_step_time_vec(
    chunk_bytes: np.ndarray, machine: MachineSpec
) -> np.ndarray:
    g = machine.group
    if machine.topology is Topology.FULL_MESH:
        per_link, n = chunk_bytes, 1
    else:
        per_link = chunk_bytes * (g - 1) / machine.a2a_links
        n = max((g - 1) // machine.a2a_links, 1)
    return comm_time_vec(
        per_link,
        machine,
        s_half=ineff.calibrated_s_half(machine),
        n_transfers=n,
    )


def hbm_move_time_vec(nbytes: np.ndarray, machine: MachineSpec) -> np.ndarray:
    return machine.kernel_latency + 2.0 * nbytes / machine.hbm_bw


# ---------------------------------------------------------------------------
# Vectorized CIL formulas.
# ---------------------------------------------------------------------------


def _mt_norm_vec(m, n, k, b, machine: MachineSpec) -> np.ndarray:
    bytes_mt = (m * k + k * n + m * n).astype(_F) * b
    return bytes_mt / ineff._mt_ref(machine)


def gemm_cil_vec(
    m, n, k, b, machine: MachineSpec, *, degree: int, dma: bool = True
) -> np.ndarray:
    p = 0.5
    c = ineff._cil_coeff(machine, "gemm", degree)
    mt_p = _mt_norm_vec(m, n, k, b, machine) ** p
    cil = 1.0 + c * (min(degree, 3) - 1) * mt_p
    if degree > 3:
        cil = cil * (1.0 + 0.02 * (degree - 3))
    if not dma:
        cil = cil + (ineff.RCCL_EXTRA_GEMM_CIL * mt_p + 0.15)
    return cil


def comm_cil_vec(
    m, n, k, b, machine: MachineSpec, *, degree: int, dma: bool = True
) -> np.ndarray:
    p = 0.5
    c = ineff._cil_coeff(machine, "comm", degree)
    mt_p = _mt_norm_vec(m, n, k, b, machine) ** p
    cil = 1.0 + c * (min(degree, 3) - 1) * mt_p
    if degree > 3:
        cil = cil * (1.0 + 0.02 * (degree - 3))
    if not dma:
        cil = cil + 0.10
    return cil


# ---------------------------------------------------------------------------
# Pipeline recurrence (vectorized scan over uniform step lists).
# ---------------------------------------------------------------------------


def pipeline_vec(comm_steps, compute_steps, deps,
                 comm_active=None, comp_active=None):
    """Vectorized two-channel pipeline over ``(S,)`` step arrays.

    ``comm_steps`` / ``compute_steps`` are short lists (length ~group) of
    per-step time arrays; ``deps[i]`` is the comm step index compute step
    ``i`` waits on (or None).  The scan performs the same additions and
    comparisons, in the same order, as ``simulator._pipeline`` — so
    per-schedule totals agree bit-for-bit with the scalar recurrence
    rather than merely to rounding tolerance.

    ``comm_active`` / ``comp_active`` turn the scan into a **masked
    ragged scan**: matching lists of per-step boolean arrays (or scalars)
    marking real steps.  An inactive step adds exactly 0.0 time and can
    never stall the compute channel, so profiles of different lengths
    batch together zero-padded and reproduce their unpadded recurrences
    bit-for-bit.  With
    masks omitted the original uniform code path runs unchanged.

    Returns ``(total, exposed, comm_sum, compute_sum)``.
    """
    finish = []
    t = None
    for s, c in enumerate(comm_steps):
        if comm_active is not None:
            c = np.where(comm_active[s], c, 0.0)
        t = c if t is None else t + c
        finish.append(t)
    zero = np.zeros_like(compute_steps[0])
    t_comp = zero
    exposed = zero
    comp_sum = None
    for i, w in enumerate(compute_steps):
        if comp_active is not None:
            w = np.where(comp_active[i], w, 0.0)
        dep = deps[i]
        if dep is not None:
            ready = finish[dep]
            stalled = ready > t_comp
            if comp_active is not None:
                stalled = stalled & comp_active[i]
            exposed = exposed + np.where(stalled, ready - t_comp, 0.0)
            t_comp = np.where(stalled, ready, t_comp)
        t_comp = t_comp + w
        comp_sum = w if comp_sum is None else comp_sum + w
    comm_sum = finish[-1] if finish else zero
    total = np.maximum(t_comp, comm_sum)
    return total, exposed, comm_sum, comp_sum


# ---------------------------------------------------------------------------
# Grid evaluation.
# ---------------------------------------------------------------------------


def _eval_one_machine(
    sb: ScenarioBatch,
    machine: MachineSpec,
    schedules,
    dma: bool,
    dma_into_place: bool,
):
    """All schedules for one machine; returns dict of (L, S) arrays."""
    g = machine.group
    m, n, k, b = sb.m, sb.n, sb.k, sb.dtype_bytes
    S = len(sb)

    dev_n = np.where(n % g == 0, n // g, n)
    mk_bytes = (m * k).astype(_F) * b
    serial_comm = ag_serial_time_vec(mk_bytes, machine)
    serial_gemm = gemm_exec_vec(m, dev_n, k, b, machine)

    m_div = (m % g == 0) & (m > 0)
    k_div = k % g == 0
    m_s = m // g
    m_sg = m_s // g

    out = {
        name: np.full((len(schedules), S), np.nan)
        for name in ("total", "comm_busy", "compute_busy", "exposed")
    }
    steps = np.zeros(len(schedules), dtype=np.int64)
    valid = np.zeros((len(schedules), S), dtype=bool)

    def put(l, ok, total, comm_busy, compute_busy, exposed, n_steps):
        out["total"][l] = np.where(ok, total, np.nan)
        out["comm_busy"][l] = np.where(ok, comm_busy, np.nan)
        out["compute_busy"][l] = np.where(ok, compute_busy, np.nan)
        out["exposed"][l] = np.where(ok, exposed, np.nan)
        steps[l] = n_steps
        valid[l] = ok

    for l, sched in enumerate(schedules):
        if sched is Schedule.SERIAL:
            total = serial_comm + serial_gemm
            put(
                l, np.ones(S, dtype=bool), total, serial_comm, serial_gemm,
                serial_comm, 1,
            )
            continue

        if sched is Schedule.SHARD_P2P:
            shard_bytes = (m_s * k).astype(_F) * b
            c_cil = comm_cil_vec(m_s, dev_n, k, b, machine, degree=2, dma=dma)
            g_cil = gemm_cil_vec(m_s, dev_n, k, b, machine, degree=2, dma=dma)
            t_p2p = p2p_step_time_vec(shard_bytes, machine) * c_cil
            t_gemm = gemm_exec_vec(m_s, dev_n, k, b, machine) * g_cil
            total, exposed, comm_sum, comp_sum = pipeline_vec(
                [t_p2p] * (g - 1),
                [t_gemm] * g,
                [None] + list(range(g - 1)),
            )
            put(l, m_div, total, comm_sum, comp_sum, exposed, g)
            continue

        # ---- FiCCO schedules -----------------------------------------
        if sched is Schedule.UNIFORM_FUSED_2D:
            k_g = k // g
            chunk_bytes = (m_s * k_g).astype(_F) * b
            step = (m, dev_n, k_g)
            gather_bytes = (m * k_g).astype(_F) * b
            scatter_bytes = None
            degree, accumulate = 4, True
            local = None
            per_step_gemms = 1
            ok = m_div & k_div
        elif sched is Schedule.UNIFORM_FUSED_1D:
            chunk_bytes = (m_sg * k).astype(_F) * b
            step = (m_s, dev_n, k)
            gather_bytes = (m_s * k).astype(_F) * b
            scatter_bytes = (m_s * dev_n).astype(_F) * b
            degree, accumulate = 4, False
            local = None
            per_step_gemms = 1
            ok = m_div
        elif sched is Schedule.HETERO_FUSED_1D:
            chunk_bytes = (m_sg * k).astype(_F) * b
            rows = (g - 1) * m_sg
            step = (rows, dev_n, k)
            gather_bytes = (rows * k).astype(_F) * b
            scatter_bytes = (rows * dev_n).astype(_F) * b
            degree, accumulate = 3, False
            local = (m_s, dev_n, k)
            per_step_gemms = 1
            ok = m_div & (m_sg >= 1)
        elif sched is Schedule.HETERO_UNFUSED_1D:
            chunk_bytes = (m_sg * k).astype(_F) * b
            step = (m_sg, dev_n, k)
            gather_bytes = np.zeros(S)
            scatter_bytes = ((g - 1) * m_sg * dev_n).astype(_F) * b
            degree, accumulate = 2, False
            local = (m_s, dev_n, k)
            per_step_gemms = g - 1
            ok = m_div & (m_sg >= 1)
        else:  # pragma: no cover
            raise ValueError(sched)

        if dma_into_place:
            gather_bytes = np.zeros(S)
            scatter_bytes = None
            degree = 2
        c_cil = comm_cil_vec(
            m_s, dev_n, k, b, machine, degree=degree, dma=dma
        )
        g_cil = gemm_cil_vec(
            step[0], step[1], step[2], b, machine, degree=degree, dma=dma
        )
        t_comm = a2a_chunk_step_time_vec(chunk_bytes, machine) * c_cil
        t_gemm_step = (
            per_step_gemms
            * gemm_exec_vec(
                step[0], step[1], step[2], b, machine, accumulate=accumulate
            )
            * g_cil
        )
        t_gather = np.where(
            gather_bytes > 0, hbm_move_time_vec(gather_bytes, machine), 0.0
        )
        if scatter_bytes is None:
            t_scatter = np.zeros(S)
        else:
            t_scatter = np.where(
                scatter_bytes > 0,
                hbm_move_time_vec(scatter_bytes, machine),
                0.0,
            )
        t_step = np.maximum(t_gemm_step, t_gather + t_scatter)

        if local is not None:
            t_local = gemm_exec_vec(
                local[0], local[1], local[2], b, machine
            ) * gemm_cil_vec(
                local[0], local[1], local[2], b, machine,
                degree=degree, dma=dma,
            )
            compute = [t_local] + [t_step] * g
            deps = [None] + list(range(g))
        else:
            compute = [t_step] * g
            deps = list(range(g))
        total, exposed, comm_sum, comp_sum = pipeline_vec(
            [t_comm] * g, compute, deps
        )
        put(l, ok, total, comm_sum, comp_sum, exposed, g)

    return out, steps, valid, serial_comm, serial_gemm


# ---------------------------------------------------------------------------
# Ragged (non-uniform step) evaluation.
# ---------------------------------------------------------------------------

_FICCO_SCHEDULES = frozenset(STUDIED)


def ragged_step_times(
    m,
    n,
    k,
    b,
    frac,
    machine: MachineSpec,
    sched: Schedule,
    *,
    dma: bool = True,
    dma_into_place: bool = False,
):
    """Per-step stream times of a ragged FiCCO decomposition (one machine).

    ``frac`` is the ``(S, P)`` per-step fraction matrix; step ``s`` of
    scenario ``i`` carries ``frac[i, s]`` of the decomposed dimension
    (capacity rows for the 1D schedules, K columns for 2D), so its comm
    chunk, gathered GEMM rows and gather/scatter traffic all scale with
    it.  The uniform engine is the special case ``frac[i, s] == 1/g``
    with ``P == g``.

    Returns ``(comm_steps, compute_steps, deps, comm_active, comp_active,
    ok)`` — lists over the (local-step +) P pipeline steps of ``(S,)``
    arrays/masks, ready for the masked :func:`pipeline_vec`.  This is the
    single source of truth for per-step times: the NumPy engine consumes
    it batched and the scalar ``simulate(..., profile=...)`` path calls
    it with ``S == 1``, so the two can only disagree in their pipeline
    scans (which the differential tests pin to each other).
    """
    if sched not in _FICCO_SCHEDULES:
        raise ValueError(
            f"ragged profiles apply to the FiCCO schedules, got {sched}"
        )
    g = machine.group
    S = m.shape[0]
    P = frac.shape[1]
    dev_n = np.where(n % g == 0, n // g, n)
    m_div = (m % g == 0) & (m > 0)
    m_s = m // g
    mf = m.astype(_F)
    msf = m_s.astype(_F)
    kf = k.astype(_F)

    if sched is Schedule.UNIFORM_FUSED_2D:
        degree, accumulate = 4, True
        local = None
        per_step_gemms = 1
    elif sched is Schedule.UNIFORM_FUSED_1D:
        degree, accumulate = 4, False
        local = None
        per_step_gemms = 1
    elif sched is Schedule.HETERO_FUSED_1D:
        degree, accumulate = 3, False
        local = (m_s, dev_n, k)
        per_step_gemms = 1
    else:  # HETERO_UNFUSED_1D
        degree, accumulate = 2, False
        local = (m_s, dev_n, k)
        per_step_gemms = g - 1
    if dma_into_place:
        degree = 2
    c_cil = comm_cil_vec(m_s, dev_n, k, b, machine, degree=degree, dma=dma)

    comm_steps, compute_steps = [], []
    comm_active, comp_active = [], []
    for s in range(P):
        f = frac[:, s]
        act = f > 0.0
        if sched is Schedule.UNIFORM_FUSED_2D:
            # The K reduction is cut raggedly; M stays whole per step.
            k_s = f * kf
            chunk_bytes = msf * k_s * b
            rows, cols, inner = mf, dev_n, k_s
            gather_bytes = mf * k_s * b
            scatter_bytes = None
        else:
            chunk_bytes = (f * msf) * kf * b
            cols, inner = dev_n, k
            if sched is Schedule.UNIFORM_FUSED_1D:
                rows = f * mf  # gathered step rows across the whole group
                gather_bytes = rows * kf * b
                scatter_bytes = rows * dev_n * b
            elif sched is Schedule.HETERO_FUSED_1D:
                rows = f * ((g - 1) * msf)  # remote rows only
                gather_bytes = rows * kf * b
                scatter_bytes = rows * dev_n * b
            else:  # HETERO_UNFUSED_1D: g-1 per-peer GEMMs per step
                rows = f * msf
                gather_bytes = None
                scatter_bytes = (g - 1) * rows * dev_n * b
        if dma_into_place:
            gather_bytes = None
            scatter_bytes = None
        t_comm = a2a_chunk_step_time_vec(chunk_bytes, machine) * c_cil
        g_cil = gemm_cil_vec(
            rows, cols, inner, b, machine, degree=degree, dma=dma
        )
        t_gemm = (
            per_step_gemms
            * gemm_exec_vec(
                rows, cols, inner, b, machine, accumulate=accumulate
            )
            * g_cil
        )
        if gather_bytes is None:
            t_gather = np.zeros(S)
        else:
            t_gather = np.where(
                gather_bytes > 0,
                hbm_move_time_vec(gather_bytes, machine),
                0.0,
            )
        if scatter_bytes is None:
            t_scatter = np.zeros(S)
        else:
            t_scatter = np.where(
                scatter_bytes > 0,
                hbm_move_time_vec(scatter_bytes, machine),
                0.0,
            )
        t_step = np.maximum(t_gemm, t_gather + t_scatter)
        comm_steps.append(t_comm)
        comm_active.append(act)
        compute_steps.append(t_step)
        comp_active.append(act)

    if local is not None:
        t_local = gemm_exec_vec(
            local[0], local[1], local[2], b, machine
        ) * gemm_cil_vec(
            local[0], local[1], local[2], b, machine, degree=degree, dma=dma
        )
        compute_steps = [t_local] + compute_steps
        comp_active = [np.ones(S, dtype=bool)] + comp_active
        deps: list[int | None] = [None] + list(range(P))
    else:
        deps = list(range(P))
    return comm_steps, compute_steps, deps, comm_active, comp_active, m_div


def _eval_one_machine_ragged(
    rb: RaggedBatch,
    machine: MachineSpec,
    schedules,
    dma: bool,
    dma_into_place: bool,
):
    """All schedules for one machine over ragged scenarios; (L, S) arrays.

    SERIAL and SHARD_P2P are profile-independent (they move the same
    aggregate bytes whatever the skew) and replicate the uniform engine
    exactly; the FiCCO schedules run the masked ragged scan.
    """
    g = machine.group
    m, n, k, b = rb.m, rb.n, rb.k, rb.dtype_bytes
    S = len(rb)

    dev_n = np.where(n % g == 0, n // g, n)
    mk_bytes = (m * k).astype(_F) * b
    serial_comm = ag_serial_time_vec(mk_bytes, machine)
    serial_gemm = gemm_exec_vec(m, dev_n, k, b, machine)

    m_div = (m % g == 0) & (m > 0)
    m_s = m // g

    out = {
        name: np.full((len(schedules), S), np.nan)
        for name in ("total", "comm_busy", "compute_busy", "exposed")
    }
    steps = np.zeros(len(schedules), dtype=np.int64)
    valid = np.zeros((len(schedules), S), dtype=bool)

    def put(l, ok, total, comm_busy, compute_busy, exposed, n_steps):
        out["total"][l] = np.where(ok, total, np.nan)
        out["comm_busy"][l] = np.where(ok, comm_busy, np.nan)
        out["compute_busy"][l] = np.where(ok, compute_busy, np.nan)
        out["exposed"][l] = np.where(ok, exposed, np.nan)
        steps[l] = n_steps
        valid[l] = ok

    for l, sched in enumerate(schedules):
        if sched is Schedule.SERIAL:
            total = serial_comm + serial_gemm
            put(
                l, np.ones(S, dtype=bool), total, serial_comm, serial_gemm,
                serial_comm, 1,
            )
            continue
        if sched is Schedule.SHARD_P2P:
            shard_bytes = (m_s * k).astype(_F) * b
            c_cil = comm_cil_vec(m_s, dev_n, k, b, machine, degree=2, dma=dma)
            g_cil = gemm_cil_vec(m_s, dev_n, k, b, machine, degree=2, dma=dma)
            t_p2p = p2p_step_time_vec(shard_bytes, machine) * c_cil
            t_gemm = gemm_exec_vec(m_s, dev_n, k, b, machine) * g_cil
            total, exposed, comm_sum, comp_sum = pipeline_vec(
                [t_p2p] * (g - 1),
                [t_gemm] * g,
                [None] + list(range(g - 1)),
            )
            put(l, m_div, total, comm_sum, comp_sum, exposed, g)
            continue
        comm, compute, deps, c_act, w_act, ok = ragged_step_times(
            m, n, k, b, rb.frac, machine, sched,
            dma=dma, dma_into_place=dma_into_place,
        )
        total, exposed, comm_sum, comp_sum = pipeline_vec(
            comm, compute, deps, c_act, w_act
        )
        put(l, ok, total, comm_sum, comp_sum, exposed, rb.max_steps)

    return out, steps, valid, serial_comm, serial_gemm


def _assemble_grid(
    sb: ScenarioBatch,
    machines,
    schedules,
    dma: bool,
    eval_one,
) -> GridResult:
    """Machine-loop assembly shared by the uniform and ragged engines."""
    machines = tuple(machines)
    L, S, M = len(schedules), len(sb), len(machines)
    total = np.empty((L, S, M))
    comm_busy = np.empty((L, S, M))
    compute_busy = np.empty((L, S, M))
    exposed = np.empty((L, S, M))
    steps = np.empty((L, M), dtype=np.int64)
    serial_comm = np.empty((S, M))
    serial_gemm = np.empty((S, M))
    valid = np.empty((L, S, M), dtype=bool)
    for j, machine in enumerate(machines):
        out, st, va, sc, sg = eval_one(machine)
        total[:, :, j] = out["total"]
        comm_busy[:, :, j] = out["comm_busy"]
        compute_busy[:, :, j] = out["compute_busy"]
        exposed[:, :, j] = out["exposed"]
        steps[:, j] = st
        valid[:, :, j] = va
        serial_comm[:, j] = sc
        serial_gemm[:, j] = sg
    return GridResult(
        schedules=tuple(schedules),
        scenarios=sb,
        machines=machines,
        total=total,
        comm_busy=comm_busy,
        compute_busy=compute_busy,
        exposed=exposed,
        steps=steps,
        serial_comm=serial_comm,
        serial_gemm=serial_gemm,
        valid=valid,
        dma=dma,
    )


def evaluate_ragged_grid(
    scenarios,
    machines,
    *,
    dma: bool = True,
    dma_into_place: bool = False,
    schedules: tuple[Schedule, ...] = GRID_SCHEDULES,
) -> GridResult:
    """Ragged counterpart of :func:`evaluate_grid`.

    ``scenarios`` is a :class:`RaggedBatch` or a list of
    :class:`~repro_torch.core.workload.RaggedScenario`.  Mixed profile lengths
    batch together (padded + masked).  Returns the same
    :class:`GridResult` shape as the uniform engine, so everything
    downstream (``GridExploration``, benchmarks, tuners) works unchanged.
    """
    rb = _as_ragged_batch(scenarios)
    return _assemble_grid(
        rb, machines, schedules, dma,
        lambda machine: _eval_one_machine_ragged(
            rb, machine, schedules, dma, dma_into_place
        ),
    )


def evaluate_grid(
    scenarios,
    machines,
    *,
    dma: bool = True,
    dma_into_place: bool = False,
    schedules: tuple[Schedule, ...] = GRID_SCHEDULES,
) -> GridResult:
    """Evaluate all ``schedules`` for S scenarios x M machines at once.

    ``scenarios`` may be a :class:`ScenarioBatch`, a list of
    :class:`~repro_torch.core.workload.Scenario`, or a list of
    :class:`~repro_torch.core.workload.GemmShape`.
    """
    sb = _as_batch(scenarios)
    return _assemble_grid(
        sb, machines, schedules, dma,
        lambda machine: _eval_one_machine(
            sb, machine, schedules, dma, dma_into_place
        ),
    )


__all__ = [
    "GRID_SCHEDULES",
    "SCHEDULE_INDEX",
    "ScenarioBatch",
    "RaggedBatch",
    "GridResult",
    "evaluate_grid",
    "evaluate_ragged_grid",
    "ragged_step_times",
    "gemm_exec_vec",
    "comm_time_vec",
    "ag_serial_time_vec",
    "p2p_step_time_vec",
    "a2a_chunk_step_time_vec",
    "hbm_move_time_vec",
    "gemm_cil_vec",
    "comm_cil_vec",
    "pipeline_vec",
]
