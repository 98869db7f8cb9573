"""Per-scenario feature extraction for schedule-selection learning (port
of ``repro.learn.features``).

The paper's claim (§VI-D) is that *inefficiency signatures* — static
quantities computable without profiling — carry enough signal to pick
bespoke FiCCO schedules.  This module turns any scenario batch (uniform
or ragged) plus a machine into a dense ``(S, F)`` feature matrix, fully
vectorized, reusing the exact formulas the heuristic gate and the
batched engines use (``repro_torch.core.heuristics.serial_gate_terms_batch``,
``repro_torch.core.batch.comm_cil_vec``) so the learner and the runtime
decision tree can never drift apart on definitions.

Features (``FEATURE_NAMES`` order):

  * ``imbalance``    — ragged-profile max/mean active-step share (1.0
                       for uniform splits).
  * ``active_steps`` — number of non-empty pipeline steps (``group``
                       for uniform splits).
  * ``otb``          — the paper's static op-to-byte ratio.
  * ``r``            — T_comm / T_gemm roofline ratio (comm-boundedness).
  * ``inflate``      — chunked/serial all-gather inflation from the
                       link model (per-chunk latency + ramp cost).
  * ``comm_cil``     — comm-side concurrency-induced-latency factor at
                       the FiCCO concurrency degree.
  * ``log_flops``    — log10 of the global GEMM's FLOPs (size scale).
  * ``m_over_k``     — M/K aspect ratio (the tree's 1D-vs-2D branch).
  * ``group``        — overlap-group size (machine param).
  * ``balance_otb``  — machine balance point, ops/byte (machine param).

The learned gate (:mod:`repro_torch.learn.gate`) conditions on the first four
(:data:`GATE_FEATURES`); the rest feed analysis and future learners.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.batch import RaggedBatch, comm_cil_vec
from repro_torch.core.engine import GridResult
from repro_torch.core.heuristics import serial_gate_terms_batch
from repro_torch.core.machine import MachineSpec

FEATURE_NAMES: tuple[str, ...] = (
    "imbalance",
    "active_steps",
    "otb",
    "r",
    "inflate",
    "comm_cil",
    "log_flops",
    "m_over_k",
    "group",
    "balance_otb",
)
FEATURE_INDEX = {name: i for i, name in enumerate(FEATURE_NAMES)}

# The subset the learned gate's threshold family conditions on.
GATE_FEATURES: tuple[str, ...] = ("imbalance", "active_steps", "otb", "r")


def profile_features(batch) -> tuple[np.ndarray, np.ndarray]:
    """``(imbalance, active_steps)`` of a batch, machine-independent.

    Uniform batches report ``imbalance == 1`` and ``active_steps == 0``
    (a sentinel the machine-aware callers replace with ``group`` — the
    uniform split's step count is a machine property, not a scenario
    one).
    """
    if isinstance(batch, RaggedBatch):
        return (
            np.asarray(batch.imbalance, dtype=np.float64),
            batch.active_steps,
        )
    S = len(batch)
    return np.ones(S), np.zeros(S)


def scenario_features(
    batch,
    machine: MachineSpec,
    *,
    imbalance=None,
    active_steps=None,
) -> np.ndarray:
    """Dense ``(S, F)`` feature matrix for one machine, vectorized.

    ``batch`` is anything the engines accept (``ScenarioBatch`` /
    ``RaggedBatch`` / scenario lists).  ``imbalance`` / ``active_steps``
    override the profile-derived values (e.g. when features are built
    from raw shape arrays instead of a batch).
    """
    from repro_torch.core import batch as _batch
    from repro_torch.core.engine import as_scenario_sequence, is_ragged

    batch = as_scenario_sequence(batch)
    sb = (
        _batch._as_ragged_batch(batch)
        if is_ragged(batch)
        else _batch._as_batch(batch)
    )
    imb, act = profile_features(sb)
    if imbalance is not None:
        imb = np.broadcast_to(
            np.asarray(imbalance, np.float64), imb.shape
        ).copy()
    if active_steps is not None:
        act = np.broadcast_to(
            np.asarray(active_steps, np.float64), act.shape
        ).copy()
    return feature_matrix(
        sb.m, sb.n, sb.k, sb.dtype_bytes, machine,
        imbalance=imb, active_steps=act,
    )


def feature_matrix(
    m,
    n,
    k,
    dtype_bytes,
    machine: MachineSpec,
    *,
    imbalance,
    active_steps,
    terms=None,
) -> np.ndarray:
    """``(S, F)`` features from raw shape arrays (the vectorized core).

    ``terms`` optionally carries precomputed
    :func:`~repro_torch.core.heuristics.serial_gate_terms_batch` output —
    callers that already evaluated the gate score (the batch selector,
    the statistics accumulator) avoid recomputing the link model.
    """
    m = np.asarray(m, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    b = np.asarray(dtype_bytes, dtype=np.float64)
    g = machine.group
    imb = np.broadcast_to(np.asarray(imbalance, np.float64), m.shape)
    act = np.asarray(
        np.broadcast_to(np.asarray(active_steps, np.float64), m.shape)
    ).copy()
    act[act == 0.0] = float(g)  # uniform sentinel -> group-step pipeline

    r, inflate = (
        terms
        if terms is not None
        else serial_gate_terms_batch(m, n, k, b, machine)
    )
    flops = 2.0 * m * n * k
    bytes_mt = (m * k + k * n + m * n) * b
    with np.errstate(divide="ignore", invalid="ignore"):
        otb = flops / bytes_mt
        m_over_k = m / k
        log_flops = np.log10(np.maximum(flops, 1.0))
    dev_n = np.where(n % g == 0, n / g, n)
    cil = comm_cil_vec(m / g, dev_n, k, b, machine, degree=4)

    S = m.shape[0]
    out = np.empty((S, len(FEATURE_NAMES)), dtype=np.float64)
    out[:, FEATURE_INDEX["imbalance"]] = imb
    out[:, FEATURE_INDEX["active_steps"]] = act
    out[:, FEATURE_INDEX["otb"]] = otb
    out[:, FEATURE_INDEX["r"]] = r
    out[:, FEATURE_INDEX["inflate"]] = inflate
    out[:, FEATURE_INDEX["comm_cil"]] = cil
    out[:, FEATURE_INDEX["log_flops"]] = log_flops
    out[:, FEATURE_INDEX["m_over_k"]] = m_over_k
    out[:, FEATURE_INDEX["group"]] = float(g)
    out[:, FEATURE_INDEX["balance_otb"]] = machine.balance_otb
    return out


def grid_features(grid: GridResult) -> np.ndarray:
    """``(S, M, F)`` features for every (scenario, machine) grid point.

    Works on any engine's :class:`~repro_torch.core.engine.GridResult` —
    features are recomputed from the batch + machine specs the grid
    carries, so a gathered sweep result is a ready-made training set.
    """
    cols = [
        scenario_features(grid.scenarios, machine)
        for machine in grid.machines
    ]
    return np.stack(cols, axis=1)


__all__ = [
    "FEATURE_NAMES",
    "FEATURE_INDEX",
    "GATE_FEATURES",
    "profile_features",
    "scenario_features",
    "feature_matrix",
    "grid_features",
]
