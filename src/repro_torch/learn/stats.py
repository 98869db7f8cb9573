"""Per-shard sufficient statistics for gate learning at sweep scale (port
of ``repro.learn.stats``).

Training a serial/overlap gate needs, for every (scenario, machine)
point, only (a) where the point lands in a *fixed* binning of the gate
features ``(imbalance, active_steps, otb, r)`` and the gate score, and
(b) what staying serial vs taking the ungated tree pick would have cost
relative to the analytic optimum.  Those reduce to an **integer
histogram**: per (feature-bin..., score-bin) cell we count points,
within-5% wins for each side, and quantized regret sums.

Because every statistic is an integer, per-shard histograms merge
*exactly* — a gate trained from summed shard statistics is
bit-identical to one trained on the gathered grid, which is what lets
``repro_torch.sweep``'s reduce mode feed 1e6–1e7-point training sweeps
without ever materializing an ``(L, S, M)`` table (the
``on_shard_grid`` hook hands each shard's GridResult to
:meth:`GateStats.update_from_grid` and drops it).

The candidate gate thresholds are the score-bin edges: choosing
threshold index ``i`` means "serial iff score >= SCORE_EDGES[i-1]"
(``i=0`` -> always serial, ``i=n_bins`` -> never), so any axis-aligned
threshold family over the binned features can be evaluated exactly from
the histogram — see :mod:`repro_torch.learn.gate` for the greedy tree grower.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core.engine import SCHEDULE_INDEX, GridResult
from repro_torch.core.heuristics import (
    select_schedule_batch,
    serial_gate_score_from_terms,
    serial_gate_terms_batch,
)
from repro_torch.core.schedule_types import Schedule
from repro_torch.learn.features import GATE_FEATURES, feature_matrix, profile_features
from repro_torch.learn import features as _features

STATS_SCHEMA = 1

# Fixed bin edges per gate feature (axis order == GATE_FEATURES).
# Values below the first edge land in bin 0; >= the last edge in the
# final bin.  Edges are part of the stats identity: two GateStats only
# merge if their edges match exactly.
FEATURE_EDGES: dict[str, tuple[float, ...]] = {
    "imbalance": (1.05, 1.25, 1.5, 2.0, 3.0, 4.5, 7.0),
    "active_steps": (1.5, 2.5, 3.5, 5.5, 8.5, 16.5),
    "otb": tuple(np.geomspace(32.0, 8192.0, 9)),
    "r": tuple(np.geomspace(1.0 / 32.0, 32.0, 11)),
}
# Candidate gate thresholds == score-bin edges (the learnable family).
SCORE_EDGES: tuple[float, ...] = tuple(np.geomspace(0.05, 20.0, 25))

# Regret (t/t_best - 1) is clipped here and quantized to integers so
# shard sums are exact; 1e7 points x 1e7 quanta stays far inside int64.
REGRET_CAP = 10.0
REGRET_SCALE = 1.0e6

# Histogram stat columns.
_N_STAT = 5
_C_COUNT, _C_W5_SERIAL, _C_W5_BASE, _C_REG_SERIAL, _C_REG_BASE = range(_N_STAT)


def _hist_shape() -> tuple[int, ...]:
    dims = tuple(len(FEATURE_EDGES[f]) + 1 for f in GATE_FEATURES)
    return dims + (len(SCORE_EDGES) + 1, _N_STAT)


def _quantize_regret(t, t_best) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        regret = t / t_best - 1.0
    regret = np.nan_to_num(
        regret, nan=REGRET_CAP, posinf=REGRET_CAP, neginf=0.0
    )
    regret = np.clip(regret, 0.0, REGRET_CAP)
    return np.rint(regret * REGRET_SCALE).astype(np.int64)


@dataclasses.dataclass
class GateStats:
    """Mergeable sufficient statistics for the learned serial gate.

    ``hist`` is the integer histogram described in the module docstring;
    ``moments`` carries per-feature (count, sum, sum-of-squares) for
    reporting (floats — informative, not part of the exact-merge
    contract); ``best_counts`` tallies the analytic optimum per
    schedule (the sweep-scale twin of ``ShardSummary.best_counts``).
    """

    hist: np.ndarray
    moments: np.ndarray  # (F, 3) float64: count, sum, sumsq
    best_counts: dict[str, int]
    n_points: int = 0
    schema: int = STATS_SCHEMA

    @classmethod
    def empty(cls) -> "GateStats":
        return cls(
            hist=np.zeros(_hist_shape(), dtype=np.int64),
            moments=np.zeros((len(_features.FEATURE_NAMES), 3)),
            best_counts={},
            n_points=0,
        )

    @classmethod
    def from_grid(cls, grid: GridResult) -> "GateStats":
        stats = cls.empty()
        stats.update_from_grid(grid)
        return stats

    # -- accumulation ---------------------------------------------------

    def update_from_grid(self, grid: GridResult, machine_indices=None) -> None:
        """Fold one (shard's) GridResult into the statistics.

        Integer columns accumulate exactly, so any sharding of the same
        grid produces the same histogram.  ``machine_indices`` restricts
        accumulation to a subset of the grid's machine axis (the
        per-machine-family training path: one grid evaluation feeds one
        :class:`GateStats` per family, and the per-family histograms sum
        exactly to the unrestricted one).
        """
        from repro_torch.core.engine import GRID_SCHEDULES

        if tuple(grid.schedules) != GRID_SCHEDULES:
            # The serial row index and the base-pick indices below are
            # SCHEDULE_INDEX positions — a schedule-subset grid would be
            # silently misread, so refuse it loudly.
            raise ValueError(
                "GateStats needs the full GRID_SCHEDULES grid, got "
                f"{tuple(s.value for s in grid.schedules)}"
            )
        sb = grid.scenarios
        S = len(sb)
        if S == 0:
            return
        imb, act = profile_features(sb)
        t = np.nan_to_num(grid.total, nan=np.inf, posinf=np.inf)
        t_best = grid.best_total()
        serial_l = SCHEDULE_INDEX[Schedule.SERIAL]
        s_idx = np.arange(S)
        if machine_indices is None:
            machine_indices = range(len(grid.machines))
        machine_indices = [int(j) for j in machine_indices]
        best = grid.best_idx()[:, machine_indices]
        for l, sched in enumerate(grid.schedules):
            n = int((best == l).sum())
            if n:
                self.best_counts[sched.value] = (
                    self.best_counts.get(sched.value, 0) + n
                )
        flat = self.hist.reshape(-1, _N_STAT)
        for j in machine_indices:
            machine = grid.machines[j]
            # One link-model evaluation feeds the score, the base picks
            # and the feature matrix alike.
            terms = serial_gate_terms_batch(
                sb.m, sb.n, sb.k, sb.dtype_bytes, machine
            )
            scores = serial_gate_score_from_terms(*terms)
            base = select_schedule_batch(
                sb.m, sb.n, sb.k, sb.dtype_bytes, machine,
                serial_gate=np.inf, terms=terms,
            )
            feats = feature_matrix(
                sb.m, sb.n, sb.k, sb.dtype_bytes, machine,
                imbalance=imb, active_steps=act, terms=terms,
            )
            t_serial = t[serial_l, :, j]
            t_pick = t[base, s_idx, j]
            tb = t_best[:, j]
            w5_serial = (t_serial <= 1.05 * tb).astype(np.int64)
            w5_base = (t_pick <= 1.05 * tb).astype(np.int64)
            reg_serial = _quantize_regret(t_serial, tb)
            reg_base = _quantize_regret(t_pick, tb)

            idx = np.zeros(S, dtype=np.int64)
            for f in GATE_FEATURES:
                edges = np.asarray(FEATURE_EDGES[f])
                col = feats[:, _features.FEATURE_INDEX[f]]
                idx = idx * (len(edges) + 1) + np.searchsorted(
                    edges, col, side="right"
                )
            idx = idx * (len(SCORE_EDGES) + 1) + np.searchsorted(
                np.asarray(SCORE_EDGES), scores, side="right"
            )
            np.add.at(flat[:, _C_COUNT], idx, 1)
            np.add.at(flat[:, _C_W5_SERIAL], idx, w5_serial)
            np.add.at(flat[:, _C_W5_BASE], idx, w5_base)
            np.add.at(flat[:, _C_REG_SERIAL], idx, reg_serial)
            np.add.at(flat[:, _C_REG_BASE], idx, reg_base)

            finite = np.isfinite(feats)
            self.moments[:, 0] += finite.sum(axis=0)
            self.moments[:, 1] += np.where(finite, feats, 0.0).sum(axis=0)
            self.moments[:, 2] += np.where(finite, feats**2, 0.0).sum(axis=0)
            self.n_points += S

    def merge(self, other: "GateStats") -> "GateStats":
        """Exact (integer) merge of two compatible statistic sets."""
        if other.schema != self.schema:
            raise ValueError(
                f"cannot merge GateStats schema {other.schema} "
                f"into schema {self.schema}"
            )
        if other.hist.shape != self.hist.shape:
            raise ValueError("GateStats bin layouts differ")
        counts = dict(self.best_counts)
        for k, v in other.best_counts.items():
            counts[k] = counts.get(k, 0) + v
        return GateStats(
            hist=self.hist + other.hist,
            moments=self.moments + other.moments,
            best_counts=counts,
            n_points=self.n_points + other.n_points,
            schema=self.schema,
        )

    def __add__(self, other: "GateStats") -> "GateStats":
        return self.merge(other)

    # -- reporting ------------------------------------------------------

    def feature_summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for i, name in enumerate(_features.FEATURE_NAMES):
            cnt, s, ss = self.moments[i]
            mean = s / cnt if cnt else 0.0
            var = max(ss / cnt - mean * mean, 0.0) if cnt else 0.0
            out[name] = {
                "count": float(cnt), "mean": mean, "std": var**0.5,
            }
        return out

    # -- serialization (multi-host stat streams) ------------------------

    def to_json(self) -> str:
        flat = self.hist.reshape(-1)
        nz = np.flatnonzero(flat)
        payload = {
            "schema": self.schema,
            "features": list(GATE_FEATURES),
            "feature_edges": {
                f: list(FEATURE_EDGES[f]) for f in GATE_FEATURES
            },
            "score_edges": list(SCORE_EDGES),
            "shape": list(self.hist.shape),
            "nz": [
                [int(i), int(v)]
                for i, v in zip(nz.tolist(), flat[nz].tolist())
            ],
            "moments": self.moments.tolist(),
            "best_counts": self.best_counts,
            "n_points": self.n_points,
        }
        return json.dumps(payload, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "GateStats":
        raw = json.loads(text)
        if raw.get("schema") != STATS_SCHEMA:
            raise ValueError(
                f"GateStats schema {raw.get('schema')!r} != {STATS_SCHEMA}"
            )
        if tuple(raw.get("shape", ())) != _hist_shape():
            raise ValueError("GateStats bin layout mismatch")
        # The bin *edges* are part of the identity too: equal-sized
        # histograms binned on different boundaries (a re-tuned
        # geomspace without a schema bump) must never merge.
        if raw.get("features") != list(GATE_FEATURES) or raw.get(
            "feature_edges"
        ) != {f: list(FEATURE_EDGES[f]) for f in GATE_FEATURES}:
            raise ValueError("GateStats feature-edge mismatch")
        if raw.get("score_edges") != list(SCORE_EDGES):
            raise ValueError("GateStats score-edge mismatch")
        hist = np.zeros(int(np.prod(_hist_shape())), dtype=np.int64)
        for i, v in raw["nz"]:
            hist[int(i)] = int(v)
        return cls(
            hist=hist.reshape(_hist_shape()),
            moments=np.asarray(raw["moments"], dtype=np.float64),
            best_counts={k: int(v) for k, v in raw["best_counts"].items()},
            n_points=int(raw["n_points"]),
        )


def sweep_stats(
    scenarios,
    machines,
    *,
    backend: str = "numpy",
    engine=None,
    num_shards: int | None = None,
    host_index: int = 0,
    host_count: int = 1,
    device_parallel: bool = False,
    dma: bool = True,
    on_shard=None,
):
    """Accumulate :class:`GateStats` over a reduce-mode sharded sweep.

    The memory-bounded training-data path: each shard's GridResult is
    folded into the statistics the moment it finishes (via
    ``sweep_grid``'s ``on_shard_grid`` hook) and then dropped — a
    1e6-point sweep trains a gate without ever gathering the grid.
    Returns ``(stats, sweep_result)``; merge stats across hosts with
    :meth:`GateStats.merge` (they serialize via ``to_json`` for the
    ``sweep_host*.jsonl``-style streams).

    ``engine`` passes an engine *instance* through to ``sweep_grid``
    (overriding ``backend``) — the fit-then-retrain path hands a
    :class:`~repro_torch.learn.fit.FittedEngine` here so the gate trains
    against the calibrated machine model instead of registry defaults.
    ``device_parallel=True`` splits each shard over the visible cards
    (``sweep_grid``).
    """
    from repro_torch.sweep import sweep_grid

    stats = GateStats.empty()
    res = sweep_grid(
        scenarios,
        machines,
        backend=backend,
        engine=engine,
        num_shards=num_shards,
        mode="reduce",
        dma=dma,
        host_index=host_index,
        host_count=host_count,
        device_parallel=device_parallel,
        on_shard=on_shard,
        on_shard_grid=lambda grid, _summ: stats.update_from_grid(grid),
    )
    return stats, res


__all__ = [
    "STATS_SCHEMA",
    "FEATURE_EDGES",
    "SCORE_EDGES",
    "REGRET_CAP",
    "REGRET_SCALE",
    "GateStats",
    "sweep_stats",
]
