"""Sweep-learned serial-gate threshold family (axis-aligned tree; port of
``repro.learn.gate``, the JSON form byte for byte the reference's).

``calibrate_serial_gate`` learns *one* scalar threshold for the
serial/overlap gate; the ragged grids showed that is not enough — the
right threshold depends on the profile's skew.  :class:`LearnedGate` generalizes the
scalar gate to a small axis-aligned decision tree over the gate
features ``(imbalance, active_steps, otb, r)``: each leaf holds its own
threshold, and a scenario stays serial iff its raw gate score
(:func:`repro_torch.core.heuristics.serial_gate_score_batch`) is ``>=`` the
threshold of the leaf its features land in.  A single-leaf tree is
exactly the scalar gate, so this strictly extends the existing family.

Training is greedy on **regret** (quantized time lost vs the analytic
optimum), driven entirely by the integer sufficient statistics of
:mod:`repro_torch.learn.stats` — so a gate trained from merged per-shard
statistics of a reduce-mode sweep is bit-identical to one trained on
the gathered grid.  Split candidates and leaf thresholds are the fixed
bin edges, which keeps every training decision exact integer
arithmetic (deterministic across shardings, platforms and runs).

The artifact is frozen, versioned and JSON-serializable
(:meth:`LearnedGate.to_json` round-trips bit-stably); persist it in the
autotune cache's artifact segment with :func:`save_gate` /
:func:`load_gate`, and install it process-wide with
:func:`set_default_gate` so the autotuner's heuristic fallback consults
it ahead of the hand-tuned gate.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math

import numpy as np

from repro_torch.core.machine import MachineSpec
from repro_torch.learn import features as _features
from repro_torch.learn.features import GATE_FEATURES, feature_matrix
from repro_torch.learn.stats import (
    _C_COUNT,
    _C_REG_BASE,
    _C_REG_SERIAL,
    _C_W5_BASE,
    _C_W5_SERIAL,
    _quantize_regret,
    FEATURE_EDGES,
    SCORE_EDGES,
    GateStats,
)

GATE_SCHEMA_VERSION = 1

# Artifact kind under which gates persist in the autotune cache segment.
GATE_ARTIFACT_KIND = "gate"


# ---------------------------------------------------------------------------
# The frozen artifact.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LearnedGate:
    """Versioned, JSON-serializable serial-gate threshold family.

    ``tree`` is a nested node dict: internal nodes are
    ``{"feature": name, "edge": float, "lo": node, "hi": node}`` (take
    ``hi`` iff the feature value is ``>= edge``); leaves are
    ``{"leaf": True, "gate": float, ...stats...}``.  A scenario stays
    serial iff ``score >= gate`` at its leaf (``-inf`` = always serial,
    ``inf`` = never) — the ``>=`` conventions match the bin edges the
    statistics were accumulated with, so applying the gate reproduces
    the training accounting exactly.
    """

    tree: dict
    features: tuple[str, ...] = GATE_FEATURES
    version: int = GATE_SCHEMA_VERSION
    meta: dict = dataclasses.field(default_factory=dict)

    # -- application ----------------------------------------------------

    def thresholds(self, X: np.ndarray) -> np.ndarray:
        """Per-row gate thresholds for an ``(S, len(features))`` matrix."""
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(X.shape[0], dtype=np.float64)
        self._apply(self.tree, X, np.arange(X.shape[0]), out)
        return out

    def _apply(self, node, X, rows, out) -> None:
        if node.get("leaf"):
            out[rows] = node["gate"]
            return
        col = self.features.index(node["feature"])
        hi = X[rows, col] >= node["edge"]
        self._apply(node["lo"], X, rows[~hi], out)
        self._apply(node["hi"], X, rows[hi], out)

    def thresholds_batch(
        self,
        m,
        n,
        k,
        dtype_bytes,
        machine: MachineSpec,
        *,
        imbalance=None,
        active_steps=None,
        terms=None,
    ) -> np.ndarray:
        """Per-scenario thresholds from raw shape arrays (what
        ``select_schedule_batch(gate=...)`` calls).

        ``terms`` forwards precomputed gate-score terms to
        :func:`~repro_torch.learn.features.feature_matrix`.
        """
        m = np.asarray(m)
        imb = 1.0 if imbalance is None else imbalance
        act = float(machine.group) if active_steps is None else active_steps
        feats = feature_matrix(
            m, n, k, dtype_bytes, machine, imbalance=imb, active_steps=act,
            terms=terms,
        )
        cols = [_features.FEATURE_INDEX[f] for f in self.features]
        return self.thresholds(feats[:, cols])

    def threshold_for(self, gemm, machine: MachineSpec, *, profile=None):
        """Scalar threshold for one GEMM (what ``select_schedule`` calls)."""
        imb = 1.0 if profile is None else float(profile.imbalance)
        act = (
            float(machine.group)
            if profile is None
            else float(profile.active_steps)
        )
        return float(
            self.thresholds_batch(
                np.asarray([gemm.m]),
                np.asarray([gemm.n]),
                np.asarray([gemm.k]),
                np.asarray([gemm.dtype_bytes]),
                machine,
                imbalance=imb,
                active_steps=act,
            )[0]
        )

    @property
    def n_leaves(self) -> int:
        def count(node):
            if node.get("leaf"):
                return 1
            return count(node["lo"]) + count(node["hi"])

        return count(self.tree)

    # -- serialization --------------------------------------------------

    def to_json(self) -> str:
        """Bit-stable canonical JSON (sorted keys, fixed separators).

        Non-finite thresholds serialize as the strings ``"-inf"`` /
        ``"inf"`` so the payload is strict JSON.
        """
        payload = {
            "version": self.version,
            "features": list(self.features),
            "tree": _encode_node(self.tree),
            "meta": self.meta,
        }
        return json.dumps(payload, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "LearnedGate":
        """Parse a serialized gate; a schema-version mismatch raises.

        Mirrors the autotune cache's wholesale invalidation: an artifact
        written by a different gate schema can never silently steer
        schedule picks — callers (``load_gate``) treat the raised
        ``ValueError`` as "no gate".
        """
        raw = json.loads(text)
        if raw.get("version") != GATE_SCHEMA_VERSION:
            raise ValueError(
                f"LearnedGate schema {raw.get('version')!r} != "
                f"{GATE_SCHEMA_VERSION}; retrain or discard the artifact"
            )
        return cls(
            tree=_decode_node(raw["tree"]),
            features=tuple(raw["features"]),
            version=int(raw["version"]),
            meta=dict(raw.get("meta", {})),
        )


def _encode_float(x: float):
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return x


def _decode_float(x) -> float:
    if isinstance(x, str):
        return float(x)
    return float(x)


def _encode_node(node: dict) -> dict:
    if node.get("leaf"):
        out = dict(node)
        out["gate"] = _encode_float(node["gate"])
        return out
    return {
        "feature": node["feature"],
        "edge": _encode_float(node["edge"]),
        "lo": _encode_node(node["lo"]),
        "hi": _encode_node(node["hi"]),
    }


def _decode_node(node: dict) -> dict:
    if node.get("leaf"):
        out = dict(node)
        out["gate"] = _decode_float(node["gate"])
        return out
    return {
        "feature": node["feature"],
        "edge": _decode_float(node["edge"]),
        "lo": _decode_node(node["lo"]),
        "hi": _decode_node(node["hi"]),
    }


# ---------------------------------------------------------------------------
# Training: greedy regret-driven growth on the integer statistics.
# ---------------------------------------------------------------------------

_THRESHOLDS = (-math.inf,) + tuple(SCORE_EDGES) + (math.inf,)


def _best_threshold(reduced: np.ndarray):
    """Best gate threshold for one region.

    ``reduced`` is the ``(n_score_bins, N_STAT)`` marginal histogram.
    Threshold index ``i`` sends score bins ``>= i`` serial; the loss is
    the total quantized regret of the implied per-point choices.
    Deterministic integer tie-breaking: lowest regret, then most
    within-5% wins, then the least-serial threshold.

    Returns ``(threshold_value, loss, win5)``.
    """
    reg_s = reduced[:, _C_REG_SERIAL]
    reg_b = reduced[:, _C_REG_BASE]
    w5_s = reduced[:, _C_W5_SERIAL]
    w5_b = reduced[:, _C_W5_BASE]
    # loss(i) = sum_{bin >= i} regret_serial + sum_{bin < i} regret_base.
    serial_tail = np.concatenate(
        [np.cumsum(reg_s[::-1])[::-1], [0]]
    )  # (n_bins + 1,)
    base_head = np.concatenate([[0], np.cumsum(reg_b)])
    loss = serial_tail + base_head
    win5 = (
        np.concatenate([np.cumsum(w5_s[::-1])[::-1], [0]])
        + np.concatenate([[0], np.cumsum(w5_b)])
    )
    order = np.lexsort((-np.arange(loss.size), -win5, loss))
    i = int(order[0])
    return _THRESHOLDS[i], int(loss[i]), int(win5[i])


def _leaf_payload(reduced: np.ndarray):
    thr, loss, win5 = _best_threshold(reduced)
    return {
        "leaf": True,
        "gate": thr,
        "n": int(reduced[:, _C_COUNT].sum()),
        "win5": win5,
        "regret_q": loss,
    }


@dataclasses.dataclass
class _Region:
    """A hyper-rectangle of feature bins during greedy growth."""

    ranges: tuple[tuple[int, int], ...]  # per feature axis: [lo, hi)
    sub: np.ndarray  # restricted histogram, feature axes + (score, stat)
    loss: int
    win5: int
    threshold: float

    @classmethod
    def from_hist(cls, hist: np.ndarray, ranges) -> "_Region":
        sub = hist
        for axis, (lo, hi) in enumerate(ranges):
            sub = np.take(sub, np.arange(lo, hi), axis=axis)
        reduced = sub.sum(axis=tuple(range(len(ranges))))
        thr, loss, win5 = _best_threshold(reduced)
        return cls(tuple(ranges), sub, loss, win5, thr)

    def best_split(self, min_points: int):
        """(gain, axis, cut, left_region_args, right_region_args) or None.

        Candidate cuts are the fixed bin boundaries interior to this
        region; evaluated for all cuts of an axis at once via prefix
        sums over the axis marginal.  Deterministic: axes in feature
        order, cuts ascending, strict improvement required.
        """
        n_axes = len(self.ranges)
        best = None
        for axis in range(n_axes):
            lo, hi = self.ranges[axis]
            if hi - lo < 2:
                continue
            other = tuple(a for a in range(n_axes) if a != axis)
            marg = self.sub.sum(axis=other)  # (axis_bins, score, stat)
            prefix = np.cumsum(marg, axis=0)
            total = prefix[-1]
            for c in range(1, hi - lo):
                left = prefix[c - 1]
                right = total - left
                if (
                    left[:, _C_COUNT].sum() < min_points
                    or right[:, _C_COUNT].sum() < min_points
                ):
                    continue
                _, l_loss, _ = _best_threshold(left)
                _, r_loss, _ = _best_threshold(right)
                gain = self.loss - l_loss - r_loss
                if gain > 0 and (best is None or gain > best[0]):
                    best = (gain, axis, lo + c)
        return best


def train_gate_from_stats(
    stats: GateStats,
    *,
    max_leaves: int = 8,
    min_points: int = 32,
    meta: dict | None = None,
) -> LearnedGate:
    """Grow the threshold tree greedily on quantized regret.

    Starts from the single-leaf (scalar-gate) family and repeatedly
    applies the highest-gain axis-aligned split until ``max_leaves`` or
    no split strictly reduces total regret.  All decisions are integer
    arithmetic on the sufficient statistics, so the result is invariant
    to how the training sweep was sharded.
    """
    hist = stats.hist
    n_axes = len(GATE_FEATURES)
    root_ranges = tuple((0, hist.shape[a]) for a in range(n_axes))
    root = _Region.from_hist(hist, root_ranges)

    # Grow: each entry is (region, node_dict_holder, key).
    tree: dict = {}
    leaves: list[tuple[_Region, dict, str]] = [(root, tree, "root")]
    while len(leaves) < max_leaves:
        # Deterministic arg-best over leaves in creation order.
        candidates = [
            (leaf.best_split(min_points), idx)
            for idx, (leaf, _, _) in enumerate(leaves)
        ]
        viable = [(c, i) for c, i in candidates if c is not None]
        if not viable:
            break
        (gain, axis, cut), idx = max(
            viable, key=lambda v: (v[0][0], -v[1])
        )
        region, holder, key = leaves.pop(idx)
        lo, hi = region.ranges[axis]
        l_ranges = list(region.ranges)
        r_ranges = list(region.ranges)
        l_ranges[axis] = (lo, cut)
        r_ranges[axis] = (cut, hi)
        left = _Region.from_hist(hist, l_ranges)
        right = _Region.from_hist(hist, r_ranges)
        feature = GATE_FEATURES[axis]
        edge = float(FEATURE_EDGES[feature][cut - 1])
        node = {"feature": feature, "edge": edge, "lo": {}, "hi": {}}
        holder[key] = node
        leaves.append((left, node, "lo"))
        leaves.append((right, node, "hi"))

    for region, holder, key in leaves:
        reduced = region.sub.sum(axis=tuple(range(n_axes)))
        holder[key] = _leaf_payload(reduced)
    root_node = tree["root"]

    info = {
        "n_points": stats.n_points,
        "trained_regret_q": sum(
            leaf["regret_q"] for leaf in _iter_leaves(root_node)
        ),
        "trained_win5": sum(
            leaf["win5"] for leaf in _iter_leaves(root_node)
        ),
    }
    if meta:
        info.update(meta)
    return LearnedGate(tree=root_node, meta=info)


def _iter_leaves(node: dict):
    if node.get("leaf"):
        yield node
    else:
        yield from _iter_leaves(node["lo"])
        yield from _iter_leaves(node["hi"])


def train_gate(source, **kw) -> LearnedGate:
    """Train from a :class:`GateStats` *or* any gathered GridResult.

    The GridResult path runs through the identical sufficient-statistics
    machinery (the grid is treated as one big shard), which is what
    guarantees sharded and gathered training agree bit-for-bit.
    """
    stats = source if isinstance(source, GateStats) else GateStats.from_grid(source)
    return train_gate_from_stats(stats, **kw)


# ---------------------------------------------------------------------------
# Regret-weighted adaptive leaf thresholds (post-training refinement).
# ---------------------------------------------------------------------------


def _per_point_tables(grid, features: tuple[str, ...]):
    """Per-(scenario, machine) gate-score / regret / win5 tables.

    The flattened, *unbinned* twin of ``GateStats.update_from_grid``:
    same terms, same base picks, same regret quantization — but kept
    per point so a threshold anywhere on the real line can be scored
    exactly, not just at the fixed bin edges.  Returns
    ``(X, scores, reg_serial, reg_base, w5_serial, w5_base)`` with rows
    concatenated machine-major.
    """
    from repro_torch.core.engine import GRID_SCHEDULES
    from repro_torch.core.heuristics import (
        select_schedule_batch,
        serial_gate_score_from_terms,
        serial_gate_terms_batch,
    )
    from repro_torch.core.schedule_types import Schedule
    from repro_torch.core.engine import SCHEDULE_INDEX
    from repro_torch.learn.features import profile_features

    if tuple(grid.schedules) != GRID_SCHEDULES:
        raise ValueError(
            "refine_gate needs the full GRID_SCHEDULES grid, got "
            f"{tuple(s.value for s in grid.schedules)}"
        )
    sb = grid.scenarios
    S = len(sb)
    imb, act = profile_features(sb)
    t = np.nan_to_num(grid.total, nan=np.inf, posinf=np.inf)
    t_best = grid.best_total()
    serial_l = SCHEDULE_INDEX[Schedule.SERIAL]
    s_idx = np.arange(S)
    cols = [_features.FEATURE_INDEX[f] for f in features]
    Xs, scs, rss, rbs, w5ss, w5bs = [], [], [], [], [], []
    for j, machine in enumerate(grid.machines):
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
        Xs.append(feats[:, cols])
        scs.append(np.asarray(scores, dtype=np.float64))
        rss.append(_quantize_regret(t_serial, tb))
        rbs.append(_quantize_regret(t_pick, tb))
        w5ss.append((t_serial <= 1.05 * tb).astype(np.int64))
        w5bs.append((t_pick <= 1.05 * tb).astype(np.int64))
    return (
        np.concatenate(Xs), np.concatenate(scs),
        np.concatenate(rss), np.concatenate(rbs),
        np.concatenate(w5ss), np.concatenate(w5bs),
    )


def _leaf_rows(node, X, rows, features, out) -> None:
    if node.get("leaf"):
        out.append((node, rows))
        return
    col = features.index(node["feature"])
    hi = X[rows, col] >= node["edge"]
    _leaf_rows(node["lo"], X, rows[~hi], features, out)
    _leaf_rows(node["hi"], X, rows[hi], features, out)


def refine_gate(
    gate: LearnedGate,
    grid,
    *,
    sub_bins: int = 8,
    meta: dict | None = None,
) -> LearnedGate:
    """Regret-weighted adaptive leaf thresholds.

    Training quantizes every candidate threshold to the fixed
    ``SCORE_EDGES`` geomspace — cheap and shard-exact, but the best
    threshold inside the winning bin interval is invisible to it.  This
    pass re-bins that interval per leaf: each leaf's rows (from
    ``grid``) are scored with the same terms/regret quantization the
    statistics used, ``sub_bins`` geomspaced sub-candidates between the
    leaf threshold's neighboring coarse candidates are evaluated by
    exact integer regret, and the leaf keeps the winner.  The current
    threshold is always a candidate, so the refined gate is never worse
    than ``gate`` on ``grid`` (regret and within-5% accounting).
    Infinite interval ends fall back to the leaf's observed score range.

    Returns a new :class:`LearnedGate`; ``meta["refine"]`` records the
    before/after quantized regret and win5 totals.
    """
    if sub_bins < 1:
        raise ValueError(f"sub_bins must be >= 1, got {sub_bins}")
    X, scores, reg_s, reg_b, w5_s, w5_b = _per_point_tables(
        grid, gate.features
    )
    tree = copy.deepcopy(gate.tree)
    leaves: list[tuple[dict, np.ndarray]] = []
    _leaf_rows(tree, X, np.arange(X.shape[0]), gate.features, leaves)
    ts = np.asarray(_THRESHOLDS)

    before_loss = before_win5 = after_loss = after_win5 = 0
    for leaf, rows in leaves:
        s = scores[rows]
        rs, rb = reg_s[rows], reg_b[rows]
        w5s, w5b = w5_s[rows], w5_b[rows]

        def _score(tau):
            serial = s >= tau
            return (
                int(rs[serial].sum() + rb[~serial].sum()),
                int(w5s[serial].sum() + w5b[~serial].sum()),
            )

        thr = float(leaf["gate"])
        cur_loss, cur_win5 = _score(thr)
        before_loss += cur_loss
        before_win5 += cur_win5
        # Interval between the coarse candidates bracketing the leaf's
        # threshold; the coarse search already proved thr beats both
        # neighbors, so only the inside of this bracket can improve.
        lo = float(ts[ts < thr].max()) if (ts < thr).any() else -math.inf
        hi = float(ts[ts > thr].min()) if (ts > thr).any() else math.inf
        if not math.isfinite(lo):
            lo = float(s.min()) if rows.size else math.nan
        if not math.isfinite(hi):
            hi = float(s.max()) if rows.size else math.nan
        best = (cur_loss, -cur_win5, -thr)
        if math.isfinite(lo) and math.isfinite(hi) and 0.0 < lo < hi:
            for tau in np.geomspace(lo, hi, sub_bins + 2)[1:-1]:
                tau = float(tau)
                loss, win5 = _score(tau)
                # Mirrors _best_threshold: lowest regret, most win5,
                # least-serial (largest) threshold.
                cand = (loss, -win5, -tau)
                if cand < best:
                    best = cand
        loss, win5, tau = best[0], -best[1], -best[2]
        leaf["gate"] = tau
        leaf["regret_q"] = loss
        leaf["win5"] = win5
        after_loss += loss
        after_win5 += win5

    info = dict(gate.meta)
    info["refine"] = {
        "sub_bins": int(sub_bins),
        "n_rows": int(X.shape[0]),
        "regret_q_before": int(before_loss),
        "regret_q_after": int(after_loss),
        "win5_before": int(before_win5),
        "win5_after": int(after_win5),
    }
    if meta:
        info["refine"].update(meta)
    return LearnedGate(
        tree=tree, features=gate.features, version=gate.version, meta=info
    )


# ---------------------------------------------------------------------------
# Evaluation helper.
# ---------------------------------------------------------------------------


def gate_accuracy(grid, gate=None, *, frac: float = 0.05, tau=None) -> float:
    """Within-``frac`` accuracy of the (optionally gated) heuristic on a
    grid — the §VI-D protocol, one call."""
    from repro_torch.core.explorer import GridExploration

    return GridExploration.from_grid(grid, tau=tau, gate=gate).accuracy(frac)


# ---------------------------------------------------------------------------
# Persistence (autotune-cache artifact segment) + process default.
# ---------------------------------------------------------------------------


def save_gate(gate: LearnedGate, *, cache=None, name: str = "default") -> None:
    """Persist a gate in the autotune cache's artifact segment."""
    from repro_torch.autotune.cache import AutotuneCache

    cache = cache if cache is not None else AutotuneCache()
    cache.put_artifact(GATE_ARTIFACT_KIND, name, json.loads(gate.to_json()))


def load_gate(*, cache=None, name: str = "default") -> LearnedGate | None:
    """Load a persisted gate; stale/mismatched artifacts yield None.

    Like the autotune decision cache, persisted gates are an
    accelerator, not a source of truth: a schema bump or corrupt
    payload means "no gate", never an error.
    """
    from repro_torch.autotune.cache import AutotuneCache

    cache = cache if cache is not None else AutotuneCache()
    raw = cache.get_artifact(GATE_ARTIFACT_KIND, name)
    if raw is None:
        return None
    try:
        return LearnedGate.from_json(json.dumps(raw))
    except (ValueError, KeyError, TypeError):
        return None


_DEFAULT_GATE: LearnedGate | None = None


def set_default_gate(gate: LearnedGate | None) -> None:
    """Install (or clear) the process-wide learned gate.

    Once set, the autotuner's zero-cost heuristic fallback consults it
    ahead of the hand-tuned scalar gate; explicit ``gate=`` arguments
    still win.
    """
    global _DEFAULT_GATE
    _DEFAULT_GATE = gate


def get_default_gate() -> LearnedGate | None:
    return _DEFAULT_GATE


# ---------------------------------------------------------------------------
# Per-machine-family gates.
# ---------------------------------------------------------------------------
#
# One global gate blurs across link models: the score -> regret mapping
# an MI300X-class machine induces is not the one a TPU-pod slice does,
# so the greedy splitter spends leaves re-separating machines instead
# of profiles.  A *family* (the machine-name prefix up to the first
# "/": ``machine_grid`` names variants ``mi300x-8/bw0.7``,
# ``tpu-v5e-axis16/lat2x``, ...) shares a link model, so per-family
# gates are trained from per-family statistics (``GateStats`` folded
# with ``machine_indices``) and installed in a process-wide registry that the heuristic
# tree's gate resolution consults between the ambient default gate and
# the hand-tuned scalar gate.

# Artifact-name prefix for persisted family gates.  Namespaced so a
# family literally named "default" can never collide with the global
# gate's artifact slot.
MACHINE_GATE_PREFIX = "machine:"

_MACHINE_GATES: dict[str, LearnedGate] = {}


def machine_family(machine) -> str:
    """Gate-family key of a machine (or machine name).

    The machine-grid naming convention puts the base machine before the
    first ``/`` and the perturbation after it (``mi300x-8/bw0.7``); the
    base machine determines the link model, hence the gate family.
    """
    name = machine if isinstance(machine, str) else machine.name
    return name.split("/", 1)[0]


def set_machine_gate(family, gate: LearnedGate | None) -> None:
    """Register (or, with ``None``, drop) the learned gate of a family.

    ``family`` may be a family key, a machine name, or a MachineSpec —
    anything :func:`machine_family` normalizes.
    """
    key = machine_family(family)
    if gate is None:
        _MACHINE_GATES.pop(key, None)
    else:
        _MACHINE_GATES[key] = gate


def get_machine_gate(machine) -> LearnedGate | None:
    """The registered family gate for a machine, or None."""
    return _MACHINE_GATES.get(machine_family(machine))


def clear_machine_gates() -> None:
    """Drop every registered family gate (test isolation hook)."""
    _MACHINE_GATES.clear()


def train_machine_gates(
    stats_by_family: dict,
    *,
    install: bool = False,
    **kw,
) -> dict[str, LearnedGate]:
    """Train one gate per family from per-family statistics.

    ``stats_by_family`` maps family keys (or machine names/specs) to
    :class:`~repro_torch.learn.stats.GateStats`; each gate's meta records its
    family.  ``install=True`` additionally registers every trained gate
    via :func:`set_machine_gate`.  Remaining keyword arguments forward
    to :func:`train_gate_from_stats` (``max_leaves``, ``min_points``,
    ``meta``).
    """
    meta_extra = dict(kw.pop("meta", None) or {})
    gates = {}
    for fam_key, stats in stats_by_family.items():
        fam = machine_family(fam_key)
        gates[fam] = train_gate_from_stats(
            stats, meta={**meta_extra, "family": fam}, **kw
        )
    if install:
        for fam, gate in gates.items():
            set_machine_gate(fam, gate)
    return gates


def save_machine_gates(gates: dict, *, cache=None) -> None:
    """Persist family gates in the artifact segment, one per family.

    Names are ``machine:<family>`` — the segment already keys artifacts
    by name, so families ride alongside the ``"default"`` global gate.
    """
    for fam_key, gate in gates.items():
        save_gate(
            gate, cache=cache,
            name=MACHINE_GATE_PREFIX + machine_family(fam_key),
        )


def load_machine_gate(machine, *, cache=None) -> LearnedGate | None:
    """Load one family's persisted gate (None when absent or stale)."""
    return load_gate(
        cache=cache, name=MACHINE_GATE_PREFIX + machine_family(machine)
    )


__all__ = [
    "GATE_SCHEMA_VERSION",
    "GATE_ARTIFACT_KIND",
    "MACHINE_GATE_PREFIX",
    "LearnedGate",
    "train_gate",
    "train_gate_from_stats",
    "refine_gate",
    "gate_accuracy",
    "save_gate",
    "load_gate",
    "set_default_gate",
    "get_default_gate",
    "machine_family",
    "set_machine_gate",
    "get_machine_gate",
    "clear_machine_gates",
    "train_machine_gates",
    "save_machine_gates",
    "load_machine_gate",
]
