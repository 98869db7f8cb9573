"""Schedule taxonomy: the FiCCO design space (paper Fig. 11a; port of
``repro.core.schedule_types``).

Three axes:
  * communication shape:  1D (row/M-sharded chunks) or 2D (column/K-sharded
    chunks; requires accumulating GEMMs C += A @ B),
  * compute uniformity:   uniform (gather local+remote so every step runs the
    identical GEMM) or hetero (start on the local shard immediately),
  * compute granularity:  fused (one GEMM per step over all received chunks)
    or unfused (one GEMM per received chunk).

2^3 = 8 schedules; the paper studies the 4 whose inefficiency signatures are
not strictly dominated, plus the serial baseline and shard-granularity P2P
overlap.  We keep all 8 enumerable so the explorer can *demonstrate* the
pruning argument rather than assert it.
"""

from __future__ import annotations

import dataclasses
import enum


class CommShape(enum.Enum):
    ONE_D = "1d"  # chunks are row (M) slices
    TWO_D = "2d"  # chunks are column (K) slices -> accumulating GEMM


class Uniformity(enum.Enum):
    UNIFORM = "uniform"
    HETERO = "hetero"


class Granularity(enum.Enum):
    FUSED = "fused"
    UNFUSED = "unfused"


class Level(enum.IntEnum):
    LOW = 0
    MEDIUM = 1
    HIGH = 2


@dataclasses.dataclass(frozen=True)
class FiccoVariant:
    shape: CommShape
    uniformity: Uniformity
    granularity: Granularity

    @property
    def name(self) -> str:
        return (
            f"{self.uniformity.value}-{self.granularity.value}-"
            f"{self.shape.value}"
        )

    @property
    def needs_gather(self) -> bool:
        # Uniform schedules combine local + remote chunks into one buffer; a
        # fused-hetero step still gathers the (g-1) remote chunks received in
        # that step (they come from distinct peers, hence non-contiguous).
        return (
            self.uniformity is Uniformity.UNIFORM
            or self.granularity is Granularity.FUSED
        )

    @property
    def needs_scatter(self) -> bool:
        # 1D schedules compute on non-contiguous row groups -> outputs are
        # scattered back into the final output space.  2D accumulates the
        # full (M, N) output in place.
        return self.shape is CommShape.ONE_D

    @property
    def accumulating(self) -> bool:
        return self.shape is CommShape.TWO_D

    @property
    def concurrency_degree(self) -> int:
        """How many engines contend at steady state (drives CIL).

        comm is always concurrent (1) + compute (1) + gather (+1) +
        scatter (+1).  Matches the paper's qualitative CIL assignment:
        uniform-fused-1D highest, hetero-unfused-1D lowest.
        """
        return 2 + int(self.needs_gather) + int(self.needs_scatter)


class Schedule(enum.Enum):
    """The executable schedules studied in the paper (+ baselines)."""

    SERIAL = "serial"
    SHARD_P2P = "shard_p2p"  # AsyncTP-style ring at shard granularity
    UNIFORM_FUSED_1D = "uniform-fused-1d"
    HETERO_FUSED_1D = "hetero-fused-1d"
    HETERO_UNFUSED_1D = "hetero-unfused-1d"
    UNIFORM_FUSED_2D = "uniform-fused-2d"

    @property
    def is_ficco(self) -> bool:
        return self not in (Schedule.SERIAL, Schedule.SHARD_P2P)

    @property
    def variant(self) -> FiccoVariant:
        if not self.is_ficco:
            raise ValueError(f"{self} has no FiCCO variant")
        return _VARIANTS[self]


_VARIANTS = {
    Schedule.UNIFORM_FUSED_1D: FiccoVariant(
        CommShape.ONE_D, Uniformity.UNIFORM, Granularity.FUSED
    ),
    Schedule.HETERO_FUSED_1D: FiccoVariant(
        CommShape.ONE_D, Uniformity.HETERO, Granularity.FUSED
    ),
    Schedule.HETERO_UNFUSED_1D: FiccoVariant(
        CommShape.ONE_D, Uniformity.HETERO, Granularity.UNFUSED
    ),
    Schedule.UNIFORM_FUSED_2D: FiccoVariant(
        CommShape.TWO_D, Uniformity.UNIFORM, Granularity.FUSED
    ),
}

ALL_VARIANTS: tuple[FiccoVariant, ...] = tuple(
    FiccoVariant(s, u, g)
    for s in CommShape
    for u in Uniformity
    for g in Granularity
)

STUDIED: tuple[Schedule, ...] = (
    Schedule.UNIFORM_FUSED_1D,
    Schedule.HETERO_FUSED_1D,
    Schedule.HETERO_UNFUSED_1D,
    Schedule.UNIFORM_FUSED_2D,
)

# Paper Fig. 12a: qualitative inefficiency-loss signatures.
SIGNATURES: dict[Schedule, tuple[Level, Level]] = {
    # (DIL degree, CIL degree)
    Schedule.UNIFORM_FUSED_1D: (Level.LOW, Level.HIGH),
    Schedule.HETERO_FUSED_1D: (Level.MEDIUM, Level.MEDIUM),
    Schedule.HETERO_UNFUSED_1D: (Level.HIGH, Level.LOW),
    Schedule.UNIFORM_FUSED_2D: (Level.LOW, Level.HIGH),
}
