"""Streaming per-decision inefficiency-signature attribution.

Port of ``repro.obs.signature``.  With ``REPRO_SIGNATURES=1`` the port
exports to a file name of its own, ``signatures-torch.jsonl`` beside the
port's autotune cache (where the reference keeps the stream in memory),
so the two packages never append to one default file.

:mod:`repro_torch.obs.timeline` renders the paper's inefficiency signature
(DIL / CIL-contention / exposed comm) for one ``simulate()`` result,
offline.  This module makes the signature a *streaming* observable: every
live schedule decision — ``Autotuner.pick``/``measure`` and the serving
tier's picks (:mod:`repro_torch.serve.adapt`) — is decomposed into
the paper's loss categories via :func:`repro_torch.core.inefficiency.
loss_components` + :func:`repro_torch.core.simulator.schedule_steps`, and
accumulated into windowed per-``(machine-family, scenario-class,
schedule)`` signature cells.  The reference's ``scripts/trace.py
signature`` overlays the accumulated signatures on the schedule grid.

The components **integrate exactly**: for every decision,
``sum(components.values()) == analytic total`` (uniform schedules split
the compute side into serial + DIL + contention; ragged lowerings keep
it whole; the ``comm_tail_s`` term closes the identity in comm-bound
regimes).  When the decision carries a measured time, the
log-residual ``log(measured / model)`` is accumulated beside the
components — the same signal :mod:`repro_torch.obs.sentinel` monitors.

Hot-path budget: the serving tier picks in tens of microseconds, so
:meth:`SignatureStream.observe_decision` memoizes the (pure, analytic)
decomposition per decision key — the steady state is one dict lookup
plus a handful of locked float adds (the reference measures it as
``obs/signature_overhead`` in its ``benchmarks/bench_obs.py``).

Enable process-wide (:func:`enable_signatures`) or via the
environment::

    REPRO_SIGNATURES=sig.jsonl python -m repro_torch.launch.serve ...

This module stays stdlib-only at import time (``repro_torch.obs``'s
``__init__`` executes while the instrumented core modules are
importing); the
simulator/inefficiency imports happen inside the functions that need
them.
"""

from __future__ import annotations

import atexit
import collections
import json
import math
import os
import threading
import time

ENV_VAR = "REPRO_SIGNATURES"
SIGNATURE_FILENAME = "signatures-torch.jsonl"

# Component keys, per lowering family (see core.inefficiency.
# loss_components): the schema validate_signature checks against.
UNIFORM_COMPONENTS = (
    "serial_gemm_s",
    "gemm_decomposition_s",
    "gemm_contention_s",
    "exposed_comm_s",
    "comm_tail_s",
)
RAGGED_COMPONENTS = ("compute_busy_s", "exposed_comm_s", "comm_tail_s")


def machine_family(name: str) -> str:
    """``tpu_v5e/dma`` -> ``tpu_v5e`` (the per-family aggregation key).

    Mirrors the reference's ``learn.gate.machine_family`` (this module
    must stay stdlib-only at import).
    """
    return name.split("/", 1)[0]


def scenario_class(gemm, profile=None) -> str:
    """Bucketed scenario identity: ``<profile-or-uniform>/f<log2 flops>``.

    Scenario classes keep the accumulator bounded under arbitrary
    traffic: GEMMs within a 2x FLOP band and the same step-profile
    family share a cell, which is the granularity the paper's
    proportion sweeps (Fig. 10) vary anyway.
    """
    flops = 2.0 * gemm.m * gemm.n * gemm.k
    band = int(math.log2(flops)) if flops > 0 else 0
    fam = "uniform" if profile is None else (profile.name or "ragged")
    return f"{fam}/f{band}"


def decision_signature(
    gemm,
    machine,
    schedule,
    *,
    group=None,
    profile=None,
    dma: bool = True,
) -> dict:
    """One decision's exactly-integrating signature decomposition.

    Lowers the scenario through :func:`~repro_torch.core.simulator.
    schedule_steps` (the same lowering ``simulate`` integrates) and
    splits the analytic total via :func:`~repro_torch.core.inefficiency.
    loss_components`.  Raises where ``simulate`` does (indivisible
    decompositions) — streaming callers catch.
    """
    from repro_torch.core.inefficiency import loss_components
    from repro_torch.core.machine import machine_for_group
    from repro_torch.core.simulator import schedule_steps

    eff = machine_for_group(machine, group) if group else machine
    steps = schedule_steps(gemm, eff, schedule, dma=dma, profile=profile)
    res = steps.run()
    components = loss_components(
        res, comm_cil=steps.comm_cil, gemm_cil=steps.gemm_cil
    )
    return {
        "schedule": res.schedule.value,
        "family": machine_family(machine.name),
        "scenario": scenario_class(gemm, profile),
        "ragged": steps.gemm_cil is None,
        "total_s": res.total,
        "comm_busy_s": res.comm_busy,
        "compute_busy_s": res.compute_busy,
        "serial_comm_s": res.serial_comm,
        "serial_gemm_s": res.serial_gemm,
        "components": components,
    }


class _CellStat:
    """count/sum/min/max of one component inside a cell (lock held by
    the owning accumulator — plain float updates here)."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def add_n(self, v: float, n: int) -> None:
        """Fold ``n`` identical observations in one step (the deferred
        flush of a memoized constant decomposition)."""
        self.count += n
        self.sum += n * v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def merge(self, other: "_CellStat") -> None:
        if not other.count:
            return
        self.count += other.count
        self.sum += other.sum
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max

    def to_json(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.sum / self.count,
        }


class _Cell:
    """One (family, scenario-class, schedule) signature histogram cell."""

    __slots__ = ("components", "total", "residual", "sources", "ragged")

    def __init__(self):
        self.components: dict[str, _CellStat] = {}
        self.total = _CellStat()
        self.residual = _CellStat()   # log(measured / model)
        self.sources: dict[str, int] = {}
        self.ragged = False


class SignatureAccumulator:
    """Windowed, bounded per-(family, scenario, schedule) signature store.

    ``max_cells`` bounds memory under arbitrary traffic (LRU beyond);
    :meth:`roll` exports the window and starts a fresh one, so a
    long-lived server produces a tail-able JSONL stream of signature
    snapshots the same way the metrics registry streams counter
    snapshots.
    """

    def __init__(self, *, max_cells: int = 512):
        self.max_cells = int(max_cells)
        self._cells: "collections.OrderedDict[tuple, _Cell]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self._window_started = time.time()
        self.evicted = 0
        # Bumped whenever a cell object may have been dropped (roll /
        # eviction): invalidates the direct cell references
        # SignatureStream memoizes for its lock-once hot path.
        self._gen = 0

    def _cell_locked(self, key: tuple, ragged: bool, comp_names) -> tuple:
        """(cell, per-component stats aligned with ``comp_names``) —
        caller holds ``self._lock``."""
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = _Cell()
            cell.ragged = ragged
            while len(self._cells) > self.max_cells:
                self._cells.popitem(last=False)
                self.evicted += 1
                self._gen += 1
        else:
            self._cells.move_to_end(key)
        stats = []
        for name in comp_names:
            stat = cell.components.get(name)
            if stat is None:
                stat = cell.components[name] = _CellStat()
            stats.append(stat)
        return cell, tuple(stats)

    def observe(
        self,
        family: str,
        scenario: str,
        schedule: str,
        components: dict,
        total_s: float,
        *,
        ragged: bool = False,
        source: str | None = None,
        model_total_s: float | None = None,
        measured_total_s: float | None = None,
    ) -> None:
        key = (family, scenario, schedule)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _Cell()
                while len(self._cells) > self.max_cells:
                    self._cells.popitem(last=False)
                    self.evicted += 1
                    self._gen += 1
            else:
                self._cells.move_to_end(key)
            cell.ragged = ragged
            cell.total.add(total_s)
            for name, v in components.items():
                stat = cell.components.get(name)
                if stat is None:
                    stat = cell.components[name] = _CellStat()
                stat.add(v)
            if source is not None:
                cell.sources[source] = cell.sources.get(source, 0) + 1
            if (
                measured_total_s is not None
                and model_total_s is not None
                and measured_total_s > 0.0
                and model_total_s > 0.0
            ):
                cell.residual.add(
                    math.log(measured_total_s / model_total_s)
                )

    def snapshot(self) -> dict:
        """One self-describing signature snapshot (schema:
        :func:`validate_signature`)."""
        with self._lock:
            cells = [
                {
                    "family": fam,
                    "scenario": scen,
                    "schedule": sched,
                    "ragged": cell.ragged,
                    "count": cell.total.count,
                    "total_s": cell.total.to_json(),
                    "components": {
                        k: s.to_json()
                        for k, s in sorted(cell.components.items())
                    },
                    "residual": cell.residual.to_json(),
                    "sources": dict(cell.sources),
                }
                for (fam, scen, sched), cell in self._cells.items()
            ]
            window_started = self._window_started
            evicted = self.evicted
        return {
            "ts": time.time(),
            "window_started": window_started,
            "cells": cells,
            "evicted": evicted,
        }

    def roll(self) -> dict:
        """Snapshot the current window, then start a fresh one."""
        snap = self.snapshot()
        with self._lock:
            self._cells.clear()
            self._gen += 1
            self._window_started = time.time()
        return snap

    def __len__(self) -> int:
        with self._lock:
            return len(self._cells)


class SignatureStream:
    """The live attribution pipeline the tuner / serving tier feed.

    ``observe_decision`` never raises and memoizes the analytic
    decomposition per decision identity (the decomposition is pure: the
    same key always yields the same components).  Because the
    decomposition is *constant* per key, repeat observations are folded
    lazily: the hot path appends one item to the memo entry's pending
    deque — a single C-atomic call, no lock — and :meth:`flush` drains pending
    items into the accumulator cells exactly (``n`` identical
    observations fold as ``count += n``, ``sum += n*v``) whenever a
    snapshot is taken, or when an entry's backlog reaches
    ``_DRAIN_AT``.  ``observed`` therefore updates at flush time, not
    per call.
    """

    _DRAIN_AT = 1024  # per-entry pending backlog that forces a drain

    def __init__(
        self,
        path: str | None = None,
        *,
        max_cells: int = 512,
        max_memo: int = 4096,
    ):
        self.path = path
        self.acc = SignatureAccumulator(max_cells=max_cells)
        self.max_memo = int(max_memo)
        # Entries: [family, scenario, schedule, ragged, comp_items,
        # total_s, pending_deque], or [None] for a decision key the
        # lowering rejects.  Pending items are the decision's source
        # string (pick path) or a (source, model_s, measured_s) tuple
        # (measure path).  One lock (the accumulator's) guards memo
        # mutation, flushing, and cells; the hit path only reads the
        # memo dict and appends to a deque, both atomic under the GIL.
        self._memo: "collections.OrderedDict[tuple, list]" = (
            collections.OrderedDict()
        )
        self._lock = self.acc._lock
        self.observed = 0
        self.errors = 0

    def observe_decision(
        self,
        gemm,
        machine,
        schedule,
        *,
        group=None,
        profile=None,
        source: str | None = None,
        model_total_s: float | None = None,
        measured_total_s: float | None = None,
    ) -> None:
        """Attribute one live decision.  Never raises — observability
        stays subordinate to the decision path's never-raise contract."""
        try:
            key = (
                machine.name,
                group,
                gemm.m, gemm.n, gemm.k, gemm.dtype_bytes,
                None if profile is None else profile.digest(),
                schedule,
            )
            entry = self._memo.get(key)
            if entry is not None:
                if entry[0] is None:  # remembered un-lowerable key
                    return
                pending = entry[6]
                pending.append(
                    source
                    if measured_total_s is None
                    else (source, model_total_s, measured_total_s)
                )
                if len(pending) >= self._DRAIN_AT:
                    with self._lock:
                        self._flush_entry_locked(entry)
                return
            # First sighting: lower + decompose outside the lock (the
            # decomposition is pure, so a concurrent double-compute is
            # just wasted work, never wrong).
            try:
                sig = decision_signature(
                    gemm, machine, schedule, group=group, profile=profile,
                )
                entry = [
                    sig["family"], sig["scenario"], sig["schedule"],
                    sig["ragged"], tuple(sig["components"].items()),
                    sig["total_s"], collections.deque(),
                ]
            except Exception:
                entry = [None]  # un-lowerable here; remember the miss
                self.errors += 1
            with self._lock:
                existing = self._memo.get(key)
                if existing is not None:
                    entry = existing  # lost the compute race
                else:
                    self._memo[key] = entry
                    while len(self._memo) > self.max_memo:
                        _, old = self._memo.popitem(last=False)
                        if old[0] is not None:
                            self._flush_entry_locked(old)
                if entry[0] is None:
                    return
                entry[6].append(
                    source
                    if measured_total_s is None
                    else (source, model_total_s, measured_total_s)
                )
        except Exception:  # pragma: no cover - observability best-effort
            self.errors += 1

    def _flush_entry_locked(self, entry: list) -> None:
        """Drain one memo entry's pending observations into its cell
        (caller holds the shared lock).

        Only the ``len()`` sampled up front is drained — items a
        concurrent decision appends mid-drain stay queued for the next
        flush, so nothing is lost and nothing double-counts.
        """
        pending = entry[6]
        n = len(pending)
        if not n:
            return
        total_s = entry[5]
        cell, stats = self.acc._cell_locked(
            (entry[0], entry[1], entry[2]), entry[3],
            [name for name, _ in entry[4]],
        )
        cell.total.add_n(total_s, n)
        for stat, (_, v) in zip(stats, entry[4]):
            stat.add_n(v, n)
        sources = cell.sources
        residual = cell.residual
        popleft = pending.popleft
        for _ in range(n):
            item = popleft()
            if type(item) is tuple:
                source, model, measured = item
                if measured is not None and measured > 0.0:
                    m = model if model is not None else total_s
                    if m > 0.0:
                        residual.add(math.log(measured / m))
            else:
                source = item
            if source is not None:
                sources[source] = sources.get(source, 0) + 1
        self.observed += n

    def flush(self) -> None:
        """Fold every pending memoized observation into the cells."""
        with self._lock:
            for entry in self._memo.values():
                if entry[0] is not None:
                    self._flush_entry_locked(entry)

    def snapshot(self) -> dict:
        self.flush()
        return self.acc.snapshot()

    def roll(self) -> dict:
        self.flush()
        return self.acc.roll()

    def export_jsonl(self, path: str | None = None, *, roll: bool = True) -> dict:
        """Append one signature-snapshot line; rolls the window by
        default.  Returns the snapshot."""
        path = path or self.path
        snap = self.roll() if roll else self.snapshot()
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(snap) + "\n")
        return snap


# ---------------------------------------------------------------------------
# Process-wide stream (what the tuner / serving tier consult).
# ---------------------------------------------------------------------------

_STREAM: SignatureStream | None = None


def enable_signatures(
    path: str | None = None, *, max_cells: int = 512, max_memo: int = 4096
) -> SignatureStream:
    """Install the process-wide signature stream (``path`` optional:
    :func:`disable_signatures` exports there)."""
    global _STREAM
    _STREAM = SignatureStream(path, max_cells=max_cells, max_memo=max_memo)
    return _STREAM


def disable_signatures() -> dict | None:
    """Uninstall the stream; exports a final snapshot first if it has a
    path.  Returns that snapshot (None if nothing was installed)."""
    global _STREAM
    s, _STREAM = _STREAM, None
    if s is not None and s.path:
        return s.export_jsonl()
    return None


def get_signatures() -> SignatureStream | None:
    return _STREAM


# ---------------------------------------------------------------------------
# Snapshot schema + report (the reference's scripts/trace.py signature).
# ---------------------------------------------------------------------------

_STAT_FIELDS = ("count", "sum", "min", "max", "mean")


def _check_stat(prefix: str, obj, errors: list[str]) -> None:
    if not isinstance(obj, dict):
        errors.append(f"{prefix}: not an object")
        return
    for field in _STAT_FIELDS:
        if not isinstance(obj.get(field), (int, float)):
            errors.append(f"{prefix}: no numeric {field!r}")


def validate_signature(obj) -> list[str]:
    """Structural errors in one signature snapshot ([] == valid)."""
    errors: list[str] = []
    if not isinstance(obj, dict):
        return [f"snapshot must be an object, got {type(obj).__name__}"]
    if not isinstance(obj.get("ts"), (int, float)):
        errors.append("missing numeric 'ts'")
    cells = obj.get("cells")
    if not isinstance(cells, list):
        return errors + ["missing 'cells' list"]
    for i, cell in enumerate(cells):
        if not isinstance(cell, dict):
            errors.append(f"cell[{i}]: not an object")
            continue
        for field in ("family", "scenario", "schedule"):
            if not isinstance(cell.get(field), str):
                errors.append(f"cell[{i}]: no {field!r} string")
        if not isinstance(cell.get("count"), int):
            errors.append(f"cell[{i}]: no integer 'count'")
        _check_stat(f"cell[{i}].total_s", cell.get("total_s"), errors)
        comps = cell.get("components")
        if not isinstance(comps, dict) or not comps:
            errors.append(f"cell[{i}]: missing 'components'")
            continue
        expected = (
            RAGGED_COMPONENTS if cell.get("ragged") else UNIFORM_COMPONENTS
        )
        for name in expected:
            if name not in comps:
                errors.append(f"cell[{i}]: no component {name!r}")
        for name, stat in comps.items():
            _check_stat(f"cell[{i}].components[{name}]", stat, errors)
        if len(errors) > 50:
            errors.append("... (truncated)")
            break
    return errors


def overlay(snapshots) -> dict:
    """Fold signature snapshots into a schedule-grid overlay.

    Returns ``{(family, scenario): {schedule: {"count", "mean_total_s",
    "dominant", "loss_fractions"}}}`` — mean decision time per cell plus
    which loss category dominates it, the observed twin of the paper's
    signature-over-design-space figures.  ``dominant`` considers only
    the *loss* components (the serial GEMM / ragged busy term is the
    work itself, not a loss).
    """
    work_terms = ("serial_gemm_s", "compute_busy_s")
    merged: dict = {}
    for snap in snapshots:
        for cell in snap.get("cells", []):
            row = merged.setdefault(
                (cell["family"], cell["scenario"]), {}
            )
            agg = row.setdefault(
                cell["schedule"],
                {"count": 0, "total_sum": 0.0, "comp_sums": {}},
            )
            agg["count"] += cell["count"]
            agg["total_sum"] += cell["total_s"]["sum"]
            for name, stat in cell["components"].items():
                agg["comp_sums"][name] = (
                    agg["comp_sums"].get(name, 0.0) + stat["sum"]
                )
    out: dict = {}
    for rowkey, row in merged.items():
        out[rowkey] = {}
        for sched, agg in row.items():
            n = agg["count"]
            losses = {
                k: v for k, v in agg["comp_sums"].items()
                if k not in work_terms
            }
            total = agg["total_sum"]
            out[rowkey][sched] = {
                "count": n,
                "mean_total_s": total / n if n else 0.0,
                "dominant": (
                    max(losses, key=losses.get) if losses else None
                ),
                "loss_fractions": {
                    k: (v / total if total else 0.0)
                    for k, v in sorted(losses.items())
                },
            }
    return out


# ---------------------------------------------------------------------------
# Environment hook: REPRO_SIGNATURES=path enables at import, exports at
# exit (same contract as REPRO_TRACE); ``1``/``true`` export to
# SIGNATURE_FILENAME beside the autotune cache.
# ---------------------------------------------------------------------------


def default_signature_path() -> str:
    """``signatures-torch.jsonl`` beside the autotune cache file."""
    from repro_torch.autotune.cache import default_cache_dir  # lazy: keep
    # this module stdlib-only at import.

    return os.path.join(default_cache_dir(), SIGNATURE_FILENAME)



def _export_at_exit() -> None:  # pragma: no cover - atexit plumbing
    s = _STREAM
    if s is not None and s.path:
        try:
            s.export_jsonl()
        except OSError:
            pass


_env = os.environ.get(ENV_VAR)
if _env:  # pragma: no cover - exercised via subprocess in tests
    enable_signatures(
        default_signature_path() if _env in ("1", "true") else _env
    )
    atexit.register(_export_at_exit)


__all__ = [
    "ENV_VAR",
    "SIGNATURE_FILENAME",
    "UNIFORM_COMPONENTS",
    "RAGGED_COMPONENTS",
    "machine_family",
    "scenario_class",
    "decision_signature",
    "SignatureAccumulator",
    "SignatureStream",
    "enable_signatures",
    "disable_signatures",
    "get_signatures",
    "default_signature_path",
    "validate_signature",
    "overlay",
]
