"""Design-space explorer: enumerate, simulate and rank every schedule
(port of ``repro.core.explorer``).

This reproduces the paper's §V-B pruning argument programmatically: of the
eight combinatorial FiCCO schedules, the four not studied have inefficiency
signatures that are (near-)strictly dominated.  ``explore`` ranks all
executable schedules for a scenario; ``prune_report`` shows why the four
extra design points lose.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import inefficiency as ineff
from repro_torch.core.batch import GridResult, RaggedBatch
from repro_torch.core.engine import Engine, get_engine
from repro_torch.core.heuristics import (
    HeuristicDecision,
    select_schedule,
    select_schedule_batch,
)
from repro_torch.core.machine import MI300X, MachineSpec
from repro_torch.core.schedule_types import (
    ALL_VARIANTS,
    STUDIED,
    CommShape,
    FiccoVariant,
    Granularity,
    Schedule,
    Uniformity,
)
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.core.workload import GemmShape, Scenario


@dataclasses.dataclass(frozen=True)
class Exploration:
    scenario: Scenario
    results: dict[Schedule, SimResult]
    best: Schedule
    heuristic: HeuristicDecision

    @property
    def heuristic_correct(self) -> bool:
        return self.heuristic.schedule is self.best

    @property
    def heuristic_loss(self) -> float:
        """Fraction of the optimal speedup lost by the heuristic's pick."""
        opt = self.results[self.best].speedup
        got = self.results[self.heuristic.schedule].speedup
        if opt <= 1.0:
            return 0.0
        return max(0.0, (opt - got) / (opt - 1.0))


def explore(
    scenario: Scenario, machine: MachineSpec, *, dma: bool = True
) -> Exploration:
    results = {
        s: simulate(scenario.gemm, machine, s, dma=dma)
        for s in (Schedule.SERIAL, Schedule.SHARD_P2P, *STUDIED)
    }
    best = min(results, key=lambda s: results[s].total)
    return Exploration(
        scenario, results, best, select_schedule(scenario.gemm, machine)
    )


@dataclasses.dataclass(frozen=True)
class GridExploration:
    """Batched exploration: simulator grid + vectorized heuristic picks.

    All arrays are indexed ``[scenario, machine]``; schedule identities are
    indices into ``grid.schedules`` (== ``GRID_SCHEDULES``).
    """

    grid: GridResult
    heuristic_idx: np.ndarray  # (S, M) indices into grid.schedules

    @classmethod
    def from_grid(
        cls, grid: GridResult, *, tau: float | None = None, gate=None
    ) -> "GridExploration":
        """Attach vectorized heuristic picks to an already-evaluated grid.

        Works on any engine's :class:`GridResult` (the heuristic is
        engine-independent); ragged grids feed their per-scenario
        imbalance (and active step counts) into the skew-aware serial
        gate.  ``gate`` (a :class:`repro_torch.learn.gate.LearnedGate`) swaps
        the scalar gate for the sweep-learned threshold family.
        """
        sb = grid.scenarios
        if isinstance(sb, RaggedBatch):
            imbalance = sb.imbalance
            active_steps = sb.active_steps
        else:
            imbalance = None
            active_steps = None
        heuristic = np.stack(
            [
                select_schedule_batch(
                    sb.m, sb.n, sb.k, sb.dtype_bytes, machine, tau=tau,
                    imbalance=imbalance, active_steps=active_steps,
                    gate=gate,
                )
                for machine in grid.machines
            ],
            axis=1,
        )
        return cls(grid, heuristic)

    @property
    def best_idx(self) -> np.ndarray:
        return self.grid.best_idx()

    @property
    def exact(self) -> np.ndarray:
        """(S, M) bool: heuristic picked the simulator-optimal schedule."""
        return self.heuristic_idx == self.best_idx

    def heuristic_total(self) -> np.ndarray:
        """(S, M) simulated time of the heuristic's pick."""
        s_idx = np.arange(len(self.grid.scenarios))[:, None]
        m_idx = np.arange(len(self.grid.machines))[None, :]
        return self.grid.total[self.heuristic_idx, s_idx, m_idx]

    def within(self, frac: float = 0.05) -> np.ndarray:
        """(S, M) bool: heuristic pick within ``frac`` of optimal time."""
        return self.heuristic_total() <= (1.0 + frac) * self.grid.best_total()

    def heuristic_loss(self) -> np.ndarray:
        """(S, M) fraction of the optimal speedup lost by the heuristic."""
        serial = self.grid.serial_total
        opt = serial / self.grid.best_total()
        got = serial / self.heuristic_total()
        with np.errstate(invalid="ignore", divide="ignore"):
            loss = (opt - got) / (opt - 1.0)
        return np.where(opt <= 1.0, 0.0, np.maximum(loss, 0.0))

    def accuracy(self, frac: float | None = None) -> float:
        """Scalar grid-wide accuracy (exact, or within ``frac`` if given)."""
        hits = self.exact if frac is None else self.within(frac)
        return float(np.mean(hits))

    def mean_misprediction_loss(self) -> float:
        """Mean speedup loss over mispredicted points (paper: ~14%)."""
        miss = ~self.exact
        if not miss.any():
            return 0.0
        # nanmean: a pick that is invalid on some machine (indivisible
        # decomposition) has no simulated time to compare against.
        return float(np.nanmean(self.heuristic_loss()[miss]))

    def summary(self) -> str:
        return (
            f"{self.exact.size} (scenario x machine) points: "
            f"exact {100 * self.accuracy():.1f}%, "
            f"within5% {100 * self.accuracy(0.05):.1f}%, "
            f"mean misprediction loss "
            f"{100 * self.mean_misprediction_loss():.1f}%"
        )


def explore_grid(
    scenarios,
    machines=(MI300X,),
    *,
    dma: bool = True,
    dma_into_place: bool = False,
    tau: float | None = None,
    backend: str = "numpy",
    engine: Engine | None = None,
    gate=None,
) -> GridExploration:
    """Batched :func:`explore` over S scenarios x M machines at once.

    Three lines to sweep a design space::

        from repro_torch.core import TABLE_I, MI300X, TPU_V5E, explore_grid
        ex = explore_grid(TABLE_I, machines=[MI300X, TPU_V5E])
        print(ex.summary())

    ``scenarios`` accepts Scenario lists, GemmShape lists or a prebuilt
    :class:`~repro_torch.core.batch.ScenarioBatch` (e.g. from
    ``workload.scenario_grid``).  ``backend`` names any engine in the
    :mod:`repro_torch.core.engine` registry — ``"numpy"`` (default),
    ``"torch"`` (float64 tensor math on the card, numbers within 1e-9 of
    numpy, differentiable for calibration) or ``"scalar"`` (the simulator
    loop); an unknown name raises a
    ``ValueError`` listing the registered engines.  ``engine=``
    passes an :class:`~repro_torch.core.engine.Engine` instance directly.

    **Ragged scenarios** (:class:`~repro_torch.core.workload.RaggedScenario`
    lists / a :class:`~repro_torch.core.batch.RaggedBatch`, e.g. from
    ``workload.ragged_scenario_grid``) route through the masked ragged
    engines on any backend; the heuristic picks then carry the
    skew-aware serial gate (``imbalance``).

    ``gate`` (a :class:`repro_torch.learn.gate.LearnedGate`) evaluates the
    heuristic with the sweep-learned threshold family instead of the
    scalar serial gate.
    """
    eng = engine if engine is not None else get_engine(backend)
    grid = eng.evaluate(
        scenarios, machines, dma=dma, dma_into_place=dma_into_place
    )
    return GridExploration.from_grid(grid, tau=tau, gate=gate)


def _variant_proxy_time(
    variant: FiccoVariant, gemm: GemmShape, machine: MachineSpec
) -> float:
    """Signature-level time proxy for *any* of the 8 variants.

    Used only to rank unstudied variants against studied ones: per-step GEMM
    size fixes DIL (via the chunk roofline), concurrency degree fixes CIL.
    """
    g = machine.group
    dev = gemm.device_gemm(g)
    if variant.shape is CommShape.TWO_D:
        base = dev.shard(g, "k")
        if variant.uniformity is Uniformity.HETERO:
            # hetero-2D: local K-slice first, then row-sharded remote K-slices
            # -> chunk GEMM additionally row-sharded: strictly smaller GEMM.
            base = base.shard(g, "m")
        if variant.granularity is Granularity.UNFUSED:
            base = base.shard(g, "m") if base.m >= g else base
        accumulate = True
    else:
        base = dev.shard(g, "m")
        if variant.granularity is Granularity.UNFUSED:
            base = base.shard(g, "m")
        accumulate = False
    # Chunk count follows from covering the device GEMM's total work.
    chunks = max(1, round(dev.flops / base.flops))
    per = ineff.gemm_exec(base, machine, accumulate=accumulate).time
    cil = ineff.gemm_cil(base, machine, degree=variant.concurrency_degree)
    chunk_bytes = float(gemm.m * gemm.k) * gemm.dtype_bytes / (g * g)
    t_comm = g * ineff.a2a_chunk_step_time(chunk_bytes, machine)
    compute = chunks * per * cil
    return max(compute, t_comm) + t_comm / g  # one exposed comm step


def prune_report(
    scenario: Scenario, machine: MachineSpec
) -> list[tuple[str, float, bool]]:
    """(variant-name, proxy time, studied?) for all 8 variants, sorted."""
    studied_names = {s.variant.name for s in STUDIED}
    rows = []
    for v in ALL_VARIANTS:
        t = _variant_proxy_time(v, scenario.gemm, machine)
        rows.append((v.name, t, v.name in studied_names))
    rows.sort(key=lambda r: r[1])
    return rows
