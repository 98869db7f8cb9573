"""Analytic DIL / CIL models (paper §IV), calibrated to the paper's data
(port of ``repro.core.inefficiency``).

Decomposition Inefficiency caused Loss (**DIL**) is *emergent* here rather
than a fudge factor: a decomposed GEMM re-reads the stationary operand once
per chunk, pays a kernel-launch latency per chunk, and loses tile-quantization
efficiency on small dimensions.  Feeding those physical terms through the
device roofline reproduces the paper's observations:

  * row (M) sharding re-reads the (K, N) weight -> hurts when M < K,
  * column (K) sharding re-reads/accumulates the (M, N) output -> hurts when
    M > K,
  * DIL anti-correlates with the GEMM's op-to-byte ratio,
  * 64-way sharding is worse than 8-way.

Contention Inefficiency caused Loss (**CIL**) is modelled as HBM-bandwidth
interference between the concurrent streams: the paper shows CIL grows with
the GEMM's static memory traffic (MT) and with the schedule's concurrency
degree, and that DMA-offloaded communication suffers far less than GPU
core-driven (RCCL) communication.  Coefficients are calibrated (bisection, at
import) so the Table-I geomeans match the paper:

  * GEMM CIL geomean 1.11x (FiCCO, DMA), 1.07x (shard overlap, DMA),
  * comm CIL geomean 1.12x (FiCCO), 1.03x (shard overlap),
  * comm DIL geomean ~1.10x for 8x-smaller all-gathers.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from repro_torch.core.machine import MachineSpec, Topology
from repro_torch.core.workload import TABLE_I, GemmShape


def _geomean_vec(vals: "np.ndarray") -> float:
    """Vectorized geomean (the calibration bisections' inner loop)."""
    return float(np.exp(np.mean(np.log(vals))))

@dataclasses.dataclass(frozen=True)
class GemmExec:
    """One GEMM kernel's modelled execution (isolated, no contention)."""

    shape: GemmShape
    time: float
    compute_time: float
    memory_time: float
    bytes_hbm: float
    occupancy: float  # useful fraction of the issued compute waves
    splits: int  # split-K factor the kernel had to use to fill the machine

    @property
    def bound(self) -> str:
        return "compute" if self.compute_time >= self.memory_time else "memory"


def gemm_exec(
    shape: GemmShape,
    machine: MachineSpec,
    *,
    accumulate: bool = False,
    hbm_bw_frac: float = 1.0,
) -> GemmExec:
    """Execution time of a single (possibly decomposed) GEMM.

    Model = roofline + execution-grain effects, which is where GEMM DIL
    (paper §IV-C1) physically comes from:

      * **wave quantization / occupancy**: the (M, N) output is tiled into
        ``tile_mn^2`` blocks scheduled over ``parallel_units`` resources.
        Small decomposed GEMMs fill a fraction of one wave.  Production
        libraries (hipblaslt stream-k, split-K) recover occupancy by
        splitting the K reduction — at the price of partial-sum traffic,
        which we charge.
      * **operand re-streaming**: padded tiles and the (K, N) weight /
        (M, N) accumulator traffic feed the memory roofline, so row-sharded
        chunks hurt when M < K and column-sharded (accumulating) chunks
        hurt when M > K, exactly the paper's observed asymmetry.
      * per-kernel launch latency.

    ``accumulate`` adds the C read-modify-write of a `C += A @ B` kernel.
    ``hbm_bw_frac`` is the bandwidth share left under contention.
    """
    m, n, k, b = shape.m, shape.n, shape.k, shape.dtype_bytes
    if m <= 0 or n <= 0 or k <= 0:
        # Degenerate chunk (e.g. hetero schedules with m < group^2):
        # surface the same ValueError contract as GemmShape.shard so
        # callers (and the batched engine's validity mask) see one
        # error type for "this decomposition does not exist".
        raise ValueError(f"degenerate GEMM chunk {shape}")
    t_mn, pu = machine.tile_mn, machine.parallel_units
    tiles = math.ceil(m / t_mn) * math.ceil(n / t_mn)
    # split-K to fill the machine when the chunk has too few output tiles.
    # Real libraries cap the split factor (partial-reduction epilogues stop
    # paying beyond ~8): tiny-output huge-K chunks stay under-occupied,
    # which is exactly the paper's "row-sharding hurts when M < K".
    splits = 1
    if tiles < pu:
        # Chunks with a single output-tile row can barely exploit split-K
        # (partials of one tile row serialize on the epilogue).
        split_cap = 2 if m <= t_mn else 8
        splits = min(
            math.ceil(pu / tiles), max(k // machine.tile_k, 1), split_cap
        )
    work = tiles * splits
    # Padded flops: partially-filled tiles still occupy their unit.
    padded_flops = (
        2.0
        * (math.ceil(m / t_mn) * t_mn)
        * (math.ceil(n / t_mn) * t_mn)
        * k
    )
    # Occupancy: blend hard wave quantization with stream-K-style smoothing
    # (real libraries recover part of, not all of, the tail wave).
    occ_quant = work / (math.ceil(work / pu) * pu)
    occ_smooth = min(1.0, work / pu)
    occupancy = 0.5 * (occ_quant + occ_smooth)
    # Reduction-depth ramp: short K chunks spend a larger fraction of each
    # tile in the MAC-pipeline prologue/epilogue (why accumulating K-sharded
    # chunks lose efficiency when K is cut 8/64-way, paper Fig. 7 right).
    k_eff = k / (k + machine.tile_k)
    compute = padded_flops / machine.peak_flops / max(occupancy * k_eff, 1e-9)

    bytes_hbm = float(m * k + k * n + m * n) * b
    if accumulate:
        bytes_hbm += float(m * n) * b  # read-modify-write of C
    if splits > 1:
        # fp32 partial tiles written + re-read for the reduction epilogue.
        bytes_hbm += 2.0 * (splits - 1) * float(m * n) * 4
    memory = bytes_hbm / (machine.hbm_bw * hbm_bw_frac)
    base = max(compute, memory)
    # Short-kernel ramp: pipeline fill/drain + cold caches take a roughly
    # fixed time slice, so kernels shorter than ~5x the ramp lose a big
    # fraction of peak.
    ramp = machine.kernel_ramp
    t = machine.kernel_latency + base * (1.0 + ramp / (base + ramp))
    return GemmExec(shape, t, compute, memory, bytes_hbm, occupancy, splits)


def gemm_time_decomposed(
    shape: GemmShape,
    machine: MachineSpec,
    ways: int,
    axis: str,
    *,
    hbm_bw_frac: float = 1.0,
) -> float:
    """Aggregate isolated time of ``ways`` chunks (serial on one device)."""
    chunk = shape.shard(ways, axis)
    per = gemm_exec(
        chunk, machine, accumulate=(axis == "k"), hbm_bw_frac=hbm_bw_frac
    )
    return ways * per.time


def gemm_dil(shape: GemmShape, machine: MachineSpec, ways: int, axis: str) -> float:
    """DIL slowdown factor: decomposed aggregate time / monolithic time."""
    base = gemm_exec(shape, machine).time
    return gemm_time_decomposed(shape, machine, ways, axis) / base


# ---------------------------------------------------------------------------
# Communication model.
# ---------------------------------------------------------------------------

# Bandwidth ramp: a transfer of size s achieves bw * s / (s + s_half).  The
# half-saturation size is calibrated below so an 8x smaller all-gather incurs
# the paper's ~10% geomean DIL at Table-I sizes.
_COMM_S_HALF_TARGET_DIL = 1.10


def comm_time(
    nbytes_per_link: float,
    machine: MachineSpec,
    *,
    s_half: float,
    n_transfers: int = 1,
) -> float:
    """Time to push ``nbytes_per_link`` through one link, ``n_transfers``
    sequential DMA descriptors (each pays latency + ramp)."""
    per = nbytes_per_link / max(n_transfers, 1)
    t_one = machine.link_latency + (per + s_half) / machine.link_bw
    return n_transfers * t_one


@functools.lru_cache(maxsize=None)
def calibrated_s_half(machine: MachineSpec) -> float:
    """Solve the ramp size so FiCCO's 8x-finer AG has ~10% geomean DIL.

    The Table-I evaluation inside each bisection step is vectorized: the
    per-scenario link loads are precomputed once and every candidate is a
    handful of array ops, so a cold cache costs microseconds instead of
    re-walking scalar Python 60x16 times (this sits on the batched sweep
    engine's cold path, see ``repro_torch.core.batch``).
    """
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


def ag_serial_time(mk_bytes: float, machine: MachineSpec) -> float:
    """Isolated all-gather of an M-sharded (M, K) buffer (baseline step S1).

    Full mesh: every device sends its shard to g-1 peers over g-1 links in
    parallel -> one shard's worth of time per link.  Torus ring: the shard is
    pipelined around the ring over ``a2a_links`` links; total ingress per
    device is (g-1)/g of the buffer.
    """
    g = machine.group
    shard = mk_bytes / g
    if machine.topology is Topology.FULL_MESH:
        per_link = shard
    else:
        per_link = mk_bytes * (g - 1) / g / machine.a2a_links
    return comm_time(per_link, machine, s_half=calibrated_s_half(machine))


def p2p_step_time(shard_bytes: float, machine: MachineSpec) -> float:
    """One ring step of shard-granularity P2P overlap (AsyncTP style).

    The defining deficiency on a full mesh (paper Fig. 13): the transfer uses
    ONE link; the other g-2 stay idle.  Over g-1 steps the communication takes
    ~(g-1)x the ideal all-gather -> the paper's observed ~7x comm slowdown.
    """
    return comm_time(
        shard_bytes / machine.p2p_links,
        machine,
        s_half=calibrated_s_half(machine),
    )


def a2a_chunk_step_time(chunk_bytes: float, machine: MachineSpec) -> float:
    """One FiCCO step: simultaneously send one chunk to each peer.

    Full mesh: (g-1) chunks leave over (g-1) links -> one chunk per link.
    Torus: the same bytes leave over ``a2a_links`` links.
    """
    g = machine.group
    if machine.topology is Topology.FULL_MESH:
        per_link, n = chunk_bytes, 1
    else:
        per_link = chunk_bytes * (g - 1) / machine.a2a_links
        n = max((g - 1) // machine.a2a_links, 1)
    return comm_time(
        per_link, machine, s_half=calibrated_s_half(machine), n_transfers=n
    )


# ---------------------------------------------------------------------------
# CIL: contention between concurrent streams.
# ---------------------------------------------------------------------------

_CIL_TARGETS = {
    # (metric, concurrency_degree): geomean slowdown from the paper §IV-D.
    ("gemm", 3): 1.11,  # FiCCO, DMA comm
    ("gemm", 2): 1.07,  # shard overlap, DMA comm
    ("comm", 3): 1.12,  # FiCCO
    ("comm", 2): 1.03,  # shard overlap
}
# GPU-core-driven communication (RCCL) additionally steals CUs from the GEMM.
# Paper Fig. 9 shows RCCL CIL far above DMA; there is no TPU analogue (ICI
# transfers are always DMA), we keep it for the paper-fidelity benchmarks.
RCCL_EXTRA_GEMM_CIL = 0.45


@functools.lru_cache(maxsize=None)
def _mt_ref(machine: MachineSpec) -> float:
    """Largest Table-I M-sharded memory traffic (the CIL normalizer)."""
    return max(s.gemm.shard(machine.group, "m").bytes_mt for s in TABLE_I)


def _mt_norm(shape: GemmShape, machine: MachineSpec) -> float:
    """Memory-traffic pressure of the 8-way M-sharded GEMM, normalized to
    the largest Table-I scenario (the paper's CIL x-axis)."""
    return shape.bytes_mt / _mt_ref(machine)


@functools.lru_cache(maxsize=None)
def _cil_coeff(machine: MachineSpec, metric: str, degree: int) -> float:
    """Calibrate `cil = 1 + c * (degree-1) * mt_norm^p` to the paper geomean.

    Vectorized like :func:`calibrated_s_half`: the Table-I pressure terms
    are precomputed as one array and each bisection step is a single
    geomean over it.
    """
    target_key = (metric, min(max(degree, 2), 3))
    target = _CIL_TARGETS[target_key]
    p = 0.5  # sub-linear: big GEMMs saturate contention
    shapes = [s.gemm.shard(machine.group, "m") for s in TABLE_I]
    xs = np.array([_mt_norm(sh, machine) ** p for sh in shapes])
    deg = target_key[1]

    def gm(c: float) -> float:
        return _geomean_vec(1.0 + c * (deg - 1) * xs)

    lo, hi = 0.0, 4.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if gm(mid) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def gemm_cil(
    shape: GemmShape,
    machine: MachineSpec,
    *,
    degree: int,
    dma: bool = True,
) -> float:
    """Slowdown of a GEMM chunk while communication (+gather/scatter) runs."""
    p = 0.5
    c = _cil_coeff(machine, "gemm", degree)
    cil = 1.0 + c * (min(degree, 3) - 1) * _mt_norm(shape, machine) ** p
    if degree > 3:  # gather+scatter both live adds residual pressure
        cil *= 1.0 + 0.02 * (degree - 3)
    if not dma:
        cil += RCCL_EXTRA_GEMM_CIL * _mt_norm(shape, machine) ** p + 0.15
    return cil


def comm_cil(
    gemm_shape: GemmShape,
    machine: MachineSpec,
    *,
    degree: int,
    dma: bool = True,
) -> float:
    """Slowdown of the communication stream from the concurrent GEMM's MT."""
    p = 0.5
    c = _cil_coeff(machine, "comm", degree)
    cil = 1.0 + c * (min(degree, 3) - 1) * _mt_norm(gemm_shape, machine) ** p
    if degree > 3:
        cil *= 1.0 + 0.02 * (degree - 3)
    if not dma:
        cil += 0.10
    return cil


def hbm_move_time(nbytes: float, machine: MachineSpec) -> float:
    """Device-local HBM copy (read + write) — Gather/Scatter cost."""
    return machine.kernel_latency + 2.0 * nbytes / machine.hbm_bw


def loss_components(
    result,
    *,
    comm_cil: float | None = None,
    gemm_cil: float | None = None,
) -> dict:
    """Exactly-integrating loss decomposition of one simulated schedule.

    Splits a :class:`~repro_torch.core.simulator.SimResult`'s end-to-end time
    into additive components that sum back to ``result.total`` in exact
    float arithmetic (modulo the usual summation rounding), so streaming
    accumulators can attribute *all* of a decision's time to a loss
    category and audits can assert ``sum(components) == total``:

      ``serial_gemm_s``          the isolated un-chunked GEMM
      ``gemm_decomposition_s``   DIL of the chunked GEMMs
                                 (busy/cil - serial: re-reads, launch
                                 latency, tile quantization)
      ``gemm_contention_s``      compute slowdown from concurrent
                                 streams (busy * (1 - 1/cil))
      ``exposed_comm_s``         comm the compute channel stalled on
      ``comm_tail_s``            comm outlasting the last compute step
                                 (total - compute-side finish; 0 when
                                 compute-bound)

    The CIL split needs the scalar factors the uniform lowering records
    (``ScheduleSteps.comm_cil``/``gemm_cil``); when they are absent
    (ragged lowerings apply CIL per step internally) the compute side
    stays whole:

      ``compute_busy_s`` + ``exposed_comm_s`` + ``comm_tail_s`` == total

    The pipeline recurrence guarantees ``total = max(compute_finish,
    comm_finish)`` with ``compute_finish = compute_busy + exposed``, so
    the tail term is what makes the identity hold in comm-bound regimes
    either way.
    """
    tail = result.total - result.compute_busy - result.exposed_comm
    if gemm_cil is not None:
        return {
            "serial_gemm_s": result.serial_gemm,
            "gemm_decomposition_s": (
                result.compute_busy / gemm_cil - result.serial_gemm
            ),
            "gemm_contention_s": (
                result.compute_busy * (1.0 - 1.0 / gemm_cil)
            ),
            "exposed_comm_s": result.exposed_comm,
            "comm_tail_s": tail,
        }
    return {
        "compute_busy_s": result.compute_busy,
        "exposed_comm_s": result.exposed_comm,
        "comm_tail_s": tail,
    }
