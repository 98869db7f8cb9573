"""FiCCO schedule selection (copy of ``repro.core.heuristics``, scalar part).

The decision tree uses only *static* GEMM parameters so a runtime can pick
a bespoke schedule without profiling (paper Fig. 12a):

  1. Communication shape: 1D if M > K else 2D — minimizes the dominant DIL
     direction (row-sharding hurts when M < K, §IV-C1).  2D has a single
     studied schedule: uniform-fused-2D.
  2. Within 1D, compare the combined OTB x MT metric (== the GEMM's FLOPs)
     against a machine threshold T = peak FLOP/s x TAU:

        metric <  T        -> uniform-fused-1D   (low DIL / high CIL)
        metric >= 5 * T    -> hetero-unfused-1D  (high DIL / low CIL)
        otherwise          -> hetero-fused-1D    (balanced)

Ahead of the tree sit two "stay serial" escapes the paper does not model:
operators below ``MIN_DECOMPOSE_FLOPS``, and the serial gate

    score = r * (inflate * CIL - 1),   r = T_comm / T_gemm (roofline),
    inflate = chunked/serial all-gather time from the link model,

serial iff ``score > gate``.  The reference also consults a learned
per-machine-family gate and a step profile here, and takes ``tau`` and
gate overrides; all come with the port's ``learn`` and tuner packages
(ROADMAP A4/A8), so this copy uses the module constants.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import linkmodel
from repro_torch.core.machine import MachineSpec
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import GemmShape

# One-time tuned horizon (seconds of peak compute), frozen after
# calibration against the reference's schedule simulator (paper §VIII-C).
DEFAULT_TAU = 0.02

# Operators too small to amortize even one extra kernel launch per chunk
# are left serial.
MIN_DECOMPOSE_FLOPS = 1.0e9

# Serial/overlap gate: stay serial when ``serial_gate_score > gate``.  The
# theory-derived breakeven is 1.0; 1.2 is the reference's grid-calibrated
# default.
DEFAULT_SERIAL_GATE = 1.2
# FiCCO comm CIL geomean (paper §IV-D) used inside the gate score.
_GATE_COMM_CIL = 1.12


def serial_gate_score(gemm: GemmShape, machine: MachineSpec) -> float:
    """Gate score ``r * (inflate * CIL - 1)``.

    ``r`` compares the serial all-gather against the peak-rate per-device
    GEMM; ``inflate`` is the chunked/serial all-gather time ratio from the
    link model (g FiCCO steps of 1/g^2-sized chunks vs one all-gather).
    """
    m = np.float64(gemm.m)
    n = np.float64(gemm.n)
    k = np.float64(gemm.k)
    g = machine.group
    dev_n = np.where(n % g == 0, n / g, n)
    mk_bytes = m * k * np.float64(gemm.dtype_bytes)
    t_comm = mk_bytes / machine.ag_bw
    t_gemm = 2.0 * m * dev_n * k / machine.peak_flops
    with np.errstate(divide="ignore", invalid="ignore"):
        r = t_comm / t_gemm
        t_serial_ag = linkmodel.ag_serial_time_vec(mk_bytes, machine)
        t_chunked_ag = g * linkmodel.a2a_chunk_step_time_vec(
            mk_bytes / (g * g), machine
        )
        inflate = t_chunked_ag / t_serial_ag
        return float(r * (inflate * _GATE_COMM_CIL - 1.0))


@dataclasses.dataclass(frozen=True)
class HeuristicDecision:
    schedule: Schedule
    metric: float  # OTB x MT == GEMM FLOPs
    threshold: float
    reason: str


def machine_threshold(machine: MachineSpec) -> float:
    """T = peak FLOP/s x TAU: 'op-to-byte x memory bandwidth = FLOPs'."""
    return machine.peak_flops * DEFAULT_TAU


def select_schedule(gemm: GemmShape, machine: MachineSpec) -> HeuristicDecision:
    """Static schedule pick (Fig. 12a tree behind the serial gate)."""
    metric = gemm.otb * gemm.bytes_mt  # == gemm.flops
    t = machine_threshold(machine)

    if gemm.flops < MIN_DECOMPOSE_FLOPS:
        return HeuristicDecision(
            Schedule.SERIAL, metric, t,
            "operator too small to amortize decomposition (beyond-paper guard)",
        )
    if serial_gate_score(gemm, machine) > DEFAULT_SERIAL_GATE:
        return HeuristicDecision(
            Schedule.SERIAL, metric, t,
            "comm-bound: chunking overhead exceeds hidden compute "
            "(grid-learned serial gate)",
        )
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


__all__ = [
    "DEFAULT_TAU",
    "MIN_DECOMPOSE_FLOPS",
    "DEFAULT_SERIAL_GATE",
    "HeuristicDecision",
    "machine_threshold",
    "serial_gate_score",
    "select_schedule",
]
