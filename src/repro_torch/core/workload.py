"""GEMM descriptors and the paper's Table I (copy of ``repro.core.workload``).

Conventions (paper §IV-C1): the *global* GEMM is (M, N, K); the activation
input (M, K) starts row-sharded over the group; weights (K, N) are resident
(column-sharded over N, which does not interact with the overlap).  Static
quantities:

  OTB  (op-to-byte)   = flops / bytes_touched          (arithmetic intensity)
  MT   (memory traffic) = M*K + K*N + M*N  elements     (paper's definition)

Only :class:`GemmShape` and :data:`TABLE_I` are kept: the heuristic reads
the first, and :func:`repro_torch.core.linkmodel.calibrated_s_half` the
second.
"""

from __future__ import annotations

import dataclasses
import enum


class CollectiveKind(enum.Enum):
    ALL_GATHER = "all_gather"
    ALL_TO_ALL = "all_to_all"


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """A global GEMM: out(M, N) = in(M, K) @ w(K, N)."""

    m: int
    n: int
    k: int
    dtype_bytes: int = 2  # bf16

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k

    @property
    def elems_mt(self) -> float:
        """Paper's memory-traffic metric MT, in elements."""
        return float(self.m * self.k + self.k * self.n + self.m * self.n)

    @property
    def bytes_mt(self) -> float:
        return self.elems_mt * self.dtype_bytes

    @property
    def otb(self) -> float:
        """Static op-to-byte ratio (paper §IV-C1)."""
        return self.flops / self.bytes_mt


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A data-dependent collective -> GEMM overlap scenario (Table I row)."""

    name: str
    parallelism: str  # "SP+TP" | "EP"
    model: str
    gemm: GemmShape
    collective: CollectiveKind = CollectiveKind.ALL_GATHER


def _sc(name: str, par: str, model: str, m: int, n: int, k: int) -> Scenario:
    kind = (
        CollectiveKind.ALL_TO_ALL if par == "EP" else CollectiveKind.ALL_GATHER
    )
    return Scenario(name, par, model, GemmShape(m, n, k), kind)


# --------------------------------------------------------------------------
# Table I: GEMMs occurring in real world scenarios.
# --------------------------------------------------------------------------
TABLE_I: tuple[Scenario, ...] = (
    _sc("g1", "SP+TP", "llama-3-405b", 16384, 16384, 131072),
    _sc("g2", "SP+TP", "llama-3-405b", 131072, 16384, 16384),
    _sc("g3", "SP+TP", "llama-3-405b", 53248, 16384, 131072),
    _sc("g4", "SP+TP", "llama-3-405b", 131072, 53248, 16384),
    _sc("g5", "SP+TP", "llama-2-70b", 8192, 8192, 262144),
    _sc("g6", "SP+TP", "llama-2-70b", 262144, 8192, 8192),
    _sc("g7", "SP+TP", "llama-2-70b", 28672, 8192, 262144),
    _sc("g8", "SP+TP", "llama-2-70b", 262144, 28672, 8192),
    _sc("g9", "SP+TP", "llama-3-405b", 196608, 18432, 16384),
    _sc("g10", "SP+TP", "llama-3-405b", 196608, 106496, 16384),
    _sc("g11", "SP+TP", "llama-2-70b", 1048576, 10240, 8192),
    _sc("g12", "SP+TP", "llama-2-70b", 1048576, 57344, 8192),
    _sc("g13", "EP", "DeepSeek", 1607680, 57344, 8192),
    _sc("g14", "EP", "Mixtral", 147456, 28672, 4096),
    _sc("g15", "EP", "Mixtral", 327680, 28672, 4096),
    _sc("g16", "EP", "Mixtral", 229376, 28672, 4096),
)


__all__ = ["CollectiveKind", "GemmShape", "Scenario", "TABLE_I"]
