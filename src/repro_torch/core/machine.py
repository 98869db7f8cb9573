"""Machine models for FiCCO cost analysis (copy of ``repro.core.machine``).

The paper characterizes an 8x AMD MI300X node with a fully-connected
Infinity-Fabric topology; the reference's deployment target was a TPU v5e
slice whose ``model`` axis is one dimension of the ICI torus.  The port adds
:data:`H100_SXM`, an 8-card H100 SXM node behind NVSwitch, and makes it the
machine ``ficco_linear`` decides for.  All three are described by the same
:class:`MachineSpec`, so the heuristic reads any of them.

Topology matters for the paper's central claim: on a *full mesh*, ring-style
peer-to-peer shard streaming uses one of ``n-1`` links per step, while a
chunk-level all-to-all uses all of them.  On a *torus ring*, P2P ring steps
are already bandwidth-optimal.  A *switch* gives every device one aggregate
port, modelled as one link of the aggregate rate.

:class:`MachineSpec` is copied field for field, the DMA-engine budgets
that the kernel-variant pruner (:mod:`repro_torch.tune.prune`) reads
included.
"""

from __future__ import annotations

import dataclasses
import enum


class Topology(enum.Enum):
    """Interconnect topology of one overlap group."""

    FULL_MESH = "full_mesh"  # MI300X: every pair directly connected.
    TORUS_RING = "torus_ring"  # one axis of a TPU ICI torus (wrap-around).
    SWITCH = "switch"  # NVSwitch-like: flexible point-to-point bandwidth.


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Static hardware description for one device + its overlap group."""

    name: str
    # Peak dense matmul throughput (FLOP/s) for the benchmark dtype (bf16).
    peak_flops: float
    # HBM bandwidth per device (bytes/s).
    hbm_bw: float
    # Uni-directional bandwidth of one inter-device link (bytes/s).
    link_bw: float
    # Number of devices in the overlap group (TP/EP group size).
    group: int
    topology: Topology
    # Links usable by a single P2P transfer (ring step).
    p2p_links: int
    # Links usable concurrently per device during an all-to-all step.
    a2a_links: int
    # Fixed per-kernel launch/setup latency (s). GPU kernel launch or TPU
    # DMA-descriptor issue. Dominates only for tiny operators.
    kernel_latency: float = 3.0e-6
    # Fixed per-transfer latency (s): DMA setup + fabric hop.
    link_latency: float = 2.0e-6
    # VMEM (TPU) / LLC (GPU) capacity per device, bytes.  Used by kernel
    # block-shape selection, not by the analytic model.
    fast_mem_bytes: int = 128 * 1024 * 1024
    # GEMM execution-grain model: output tiles of tile_mn x tile_mn are
    # distributed over `parallel_units` concurrent execution resources
    # (CUs on MI300X, SMs on H100; pipelined MXU tile slots on TPU).
    tile_mn: int = 256
    tile_k: int = 256
    parallel_units: int = 304
    # Pipeline fill/drain + cold-cache ramp of one kernel.
    kernel_ramp: float = 20.0e-6
    # DMA-engine resource budgets, consumed by the kernel-variant
    # feasibility pruner (repro_torch.tune.prune), not by the analytic
    # model: completion-semaphore slots one kernel may allocate, regular
    # (flow-control) semaphore slots, and the minimum granule one DMA
    # descriptor moves efficiently (transfers must be a whole multiple).
    dma_sem_slots: int = 128
    reg_sem_slots: int = 32
    dma_granule: int = 512

    # ---- derived ------------------------------------------------------
    @property
    def balance_otb(self) -> float:
        """Machine balance point, ops/byte: OTB above this is compute bound."""
        return self.peak_flops / self.hbm_bw

    @property
    def ag_bw(self) -> float:
        """Aggregate egress bandwidth one device can use for an all-gather.

        Full mesh: a device sends its shard to ``n-1`` peers over ``n-1``
        dedicated links concurrently.  Torus ring: collectives are chained
        through 2 neighbour links (both directions).  Switch: one port.
        """
        if self.topology is Topology.FULL_MESH:
            return self.link_bw * (self.group - 1)
        return self.link_bw * self.a2a_links


# ---------------------------------------------------------------------------
# Paper machine: 8x MI300X, fully-connected Infinity Fabric.
#   - 1307.4 TFLOP/s peak bf16 per GPU, 5.3 TB/s HBM3, 64 GB/s/link uni-dir.
# ---------------------------------------------------------------------------
MI300X = MachineSpec(
    name="mi300x-8",
    peak_flops=1307.4e12,
    hbm_bw=5.3e12,
    link_bw=64e9,
    group=8,
    topology=Topology.FULL_MESH,
    p2p_links=1,
    a2a_links=7,
    fast_mem_bytes=256 * 1024 * 1024,  # LLC (Infinity Cache)
    tile_mn=256,
    tile_k=256,
    parallel_units=304,  # CUs
    kernel_ramp=20.0e-6,
)

# ---------------------------------------------------------------------------
# The reference's deployment target: TPU v5e, ``model`` axis = 16 devices
# along one torus dimension (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link).
# ---------------------------------------------------------------------------
TPU_V5E = MachineSpec(
    name="tpu-v5e-axis16",
    peak_flops=197e12,
    hbm_bw=819e9,
    link_bw=50e9,
    group=16,
    topology=Topology.TORUS_RING,
    p2p_links=1,
    a2a_links=2,
    kernel_latency=1.0e-6,  # DMA descriptor issue; no host launch on-path.
    link_latency=1.5e-6,
    fast_mem_bytes=128 * 1024 * 1024,  # VMEM
    tile_mn=128,
    tile_k=128,
    parallel_units=8,  # MXU pipeline slots; occupancy matters far less.
    kernel_ramp=2.0e-6,  # systolic fill is short; no cold-start kernels.
)

# ---------------------------------------------------------------------------
# The port's target: 8x H100 SXM behind NVSwitch.  Data-sheet numbers, not
# measurements: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 50 MB L2, 132 SMs,
# NVLink 4 at 450 GB/s per direction in aggregate, which the switch lets
# one transfer use whole (one link of the aggregate rate).  Latencies and
# ramp keep the reference's GPU defaults until measurements fit them.
# fast_mem_bytes is the L2, the reference's "LLC (GPU)" convention (MI300X
# gives its LLC): the variant pruner counts a kernel's whole weight shard
# and step buffers against it (12-27 MB at TinyLlama-1.1B's projection), so
# the 227 KB of shared memory per block would reject every variant.  The
# DMA-engine budgets keep their defaults: the copy engines take
# cudaMemcpyAsync calls and allocate no semaphores, and a chunk's bytes are
# a whole multiple of 512 at every shape the port runs.
# ---------------------------------------------------------------------------
H100_SXM = MachineSpec(
    name="h100-sxm-8",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    group=8,
    topology=Topology.SWITCH,
    p2p_links=1,
    a2a_links=1,
    fast_mem_bytes=50 * 1024 * 1024,  # L2
    tile_mn=128,
    parallel_units=132,  # SMs
)

MACHINES = {m.name: m for m in (MI300X, TPU_V5E, H100_SXM)}


def machine_for_group(machine: MachineSpec, group: int) -> MachineSpec:
    """Re-target a machine model at a different overlap-group size.

    On a full mesh the per-device all-to-all link count tracks the group
    (every peer is directly attached); torus and switch link counts are
    physical and stay put.
    """
    if group == machine.group:
        return machine
    a2a = (
        group - 1
        if machine.topology is Topology.FULL_MESH
        else machine.a2a_links
    )
    return dataclasses.replace(machine, group=group, a2a_links=a2a)


def get_machine(name: str) -> MachineSpec:
    try:
        return MACHINES[name]
    except KeyError:
        raise KeyError(f"unknown machine {name!r}; known: {sorted(MACHINES)}")


__all__ = [
    "Topology",
    "MachineSpec",
    "MI300X",
    "TPU_V5E",
    "H100_SXM",
    "MACHINES",
    "machine_for_group",
    "get_machine",
]
