"""The link model the serial gate reads.

Copies of ``calibrated_s_half`` and ``_geomean_vec`` from
``repro.core.inefficiency`` and of ``comm_time_vec``,
``ag_serial_time_vec`` and ``a2a_chunk_step_time_vec`` from
``repro.core.batch``, formulas unchanged.  A transfer of size s achieves
``bw * s / (s + s_half)``; ``s_half`` is solved per machine so that FiCCO's
8x-finer all-gather pays the paper's ~10 % geomean DIL at Table-I sizes.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.machine import MachineSpec, Topology
from repro_torch.core.workload import TABLE_I

# The half-saturation size is calibrated so an 8x smaller all-gather incurs
# the paper's ~10% geomean DIL at Table-I sizes.
_COMM_S_HALF_TARGET_DIL = 1.10


def _geomean_vec(vals: "np.ndarray") -> float:
    """Vectorized geomean (the calibration bisection's inner loop)."""
    return float(np.exp(np.mean(np.log(vals))))


@functools.lru_cache(maxsize=None)
def calibrated_s_half(machine: MachineSpec) -> float:
    """Solve the ramp size so FiCCO's 8x-finer AG has ~10% geomean DIL."""
    g = machine.group
    shard_per_link = np.array(
        [
            sc.gemm.m * sc.gemm.k * sc.gemm.dtype_bytes
            / g
            / max(machine.a2a_links, 1)
            for sc in TABLE_I
        ],
        dtype=np.float64,
    )
    base = machine.link_latency + shard_per_link / machine.link_bw

    def dil_geomean(s_half: float) -> float:
        fine = g * (
            machine.link_latency
            + (shard_per_link / g + s_half) / machine.link_bw
        )
        return _geomean_vec(fine / base)

    lo, hi = 0.0, 64 * 1024 * 1024
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if dil_geomean(mid) < _COMM_S_HALF_TARGET_DIL:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


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
    """Isolated all-gather of an M-sharded (M, K) buffer."""
    g = machine.group
    if machine.topology is Topology.FULL_MESH:
        per_link = mk_bytes / g
    else:
        per_link = mk_bytes * (g - 1) / g / machine.a2a_links
    return comm_time_vec(
        per_link, machine, s_half=calibrated_s_half(machine)
    )


def a2a_chunk_step_time_vec(
    chunk_bytes: np.ndarray, machine: MachineSpec
) -> np.ndarray:
    """One FiCCO step: a chunk to every peer, all links at once."""
    g = machine.group
    if machine.topology is Topology.FULL_MESH:
        per_link, n = chunk_bytes, 1
    else:
        per_link = chunk_bytes * (g - 1) / machine.a2a_links
        n = max((g - 1) // machine.a2a_links, 1)
    return comm_time_vec(
        per_link,
        machine,
        s_half=calibrated_s_half(machine),
        n_transfers=n,
    )


__all__ = [
    "calibrated_s_half",
    "comm_time_vec",
    "ag_serial_time_vec",
    "a2a_chunk_step_time_vec",
]
