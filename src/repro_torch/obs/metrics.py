"""Counter/histogram metrics registry with JSONL snapshot export.

Port of ``repro.obs.metrics`` (a copy: the port imports nothing of
``repro``).  A process-wide registry that the port's serve engine, train
loop and schedule resolution report into, with the reference's metric
names.  Counters are one locked attribute increment, histograms one
locked reservoir update.

Both metric types are **thread-safe**: every mutation and every
consistent read (``to_json``) takes the instance's own lock, so
``snapshot()`` never sees ``total`` disagree with ``count``.

Histograms are **bounded**: ``count``/``sum``/``min``/``max`` stay exact;
percentiles come from a fixed-size uniform reservoir (Vitter's
algorithm R, ``RESERVOIR_SIZE`` samples) — exact until the reservoir
fills, afterwards a uniform random sample whose nearest-rank
percentiles carry the usual ~1/sqrt(K) sampling error.  The reservoir
RNG is seeded per instance, so single-threaded runs are reproducible.

Snapshots are JSON dictionaries; :meth:`MetricsRegistry.export_jsonl`
appends one line per snapshot, in the reference's schema
(:func:`validate_snapshot`), so the reference's tools read the port's
stream.

Metric key glossary (the names the port's instrumentation uses):

  ``serve/tokens``,``serve/steps``  tokens emitted / decode steps run
  ``train/steps``            train steps run
  ``overlap/resolve.<how>``  schedule resolutions (explicit|named|auto|
                             autotune|autotune_fallback)
  ``tuner/decisions``        tuner decisions (pick + measure)
  ``tuner/pick.<tier>``      decisions by tier (cache|analytic|measured|
                             heuristic); :func:`tuner_tier_rates`
  ``tuner/pick_seconds``     host seconds per decision (histogram)
  ``tuner/measure``          measured-tier sessions
  ``tuner/measure_variants`` kernel-variant timings recorded
  ``gate/agree``,``gate/points``  :func:`observe_gate_agreement`
"""

from __future__ import annotations

import json
import math
import os
import random
import threading
import time


class Counter:
    """Monotonic counter.  ``inc`` is atomic under its own lock — the
    GIL does not make ``self.value += n`` atomic (read-add-store can
    interleave), and the serving tier increments from many threads.

    ``lock`` lets a registry share one (reentrant) lock across all its
    metrics so ``snapshot()`` can read every counter and histogram in a
    single consistent pass; standalone instances keep a private lock.
    """

    __slots__ = ("value", "_lock")

    def __init__(self, *, lock=None):
        self.value = 0
        self._lock = lock if lock is not None else threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


# Reservoir size: percentiles are exact below this many observations,
# a uniform sample above it (~1.6pp worst-case p50/p95 error at 95%
# confidence).  Bounded regardless of process lifetime.
RESERVOIR_SIZE = 4096


class Histogram:
    """Bounded-reservoir histogram with exact count/sum and percentile
    export.

    ``count``/``total``/``min``/``max`` are exact for every observation
    ever made; ``percentile`` is nearest-rank over a fixed-size uniform
    reservoir (algorithm R) — exact while ``count <= RESERVOIR_SIZE``,
    a documented-accuracy sample beyond that.  All mutation and
    consistent reads lock, so concurrent ``observe`` never loses
    samples and ``to_json`` never reports ``sum`` torn against
    ``count``.
    """

    __slots__ = ("_samples", "total", "_count", "_min", "_max",
                 "_rng", "_lock")

    def __init__(self, *, seed: int = 0, lock=None):
        self._samples: list[float] = []
        self.total = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._rng = random.Random(seed)
        self._lock = lock if lock is not None else threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self.total += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._samples) < RESERVOIR_SIZE:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < RESERVOIR_SIZE:
                    self._samples[j] = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def values(self) -> list[float]:
        """A copy of the retained reservoir samples (NOT the full
        observation history once ``count > RESERVOIR_SIZE``)."""
        with self._lock:
            return list(self._samples)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the reservoir; ``q`` in [0, 1].
        0.0 when empty; exact until the reservoir fills."""
        with self._lock:
            ordered = sorted(self._samples)
        if not ordered:
            return 0.0
        rank = max(math.ceil(q * len(ordered)), 1) - 1
        return ordered[min(rank, len(ordered) - 1)]

    def to_json(self, *, reservoir: bool = False) -> dict:
        """Exact count/sum/min/max + reservoir percentiles.

        ``reservoir=True`` additionally exports the retained samples —
        what :func:`merge_snapshots` needs to compute cross-host
        percentiles exactly (within reservoir-sampling tolerance)
        instead of approximating from per-host p50/p95.
        """
        with self._lock:
            if not self._count:
                out = {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                       "p50": 0.0, "p95": 0.0}
                if reservoir:
                    out["reservoir"] = []
                return out
            count = self._count
            total = self.total
            lo, hi = self._min, self._max
            samples = list(self._samples)
        ordered = sorted(samples)

        def rank(q: float) -> float:
            r = max(math.ceil(q * len(ordered)), 1) - 1
            return ordered[min(r, len(ordered) - 1)]

        out = {
            "count": count,
            "sum": total,
            "min": lo,
            "max": hi,
            "p50": rank(0.50),
            "p95": rank(0.95),
        }
        if reservoir:
            out["reservoir"] = samples
        return out


def host_identity(overrides: dict | None = None) -> dict:
    """This process's identity stamp for exported obs artifacts.

    ``hostname``/``pid`` identify the process; ``host_index`` is the
    host rank (``REPRO_HOST_INDEX``, or an explicit override) that lets
    :func:`merge_snapshots` line multi-host exports up.
    """
    import socket

    ident = {
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "host_index": int(os.environ.get("REPRO_HOST_INDEX", "0") or 0),
    }
    if overrides:
        ident.update(overrides)
    return ident


def _clock_anchor() -> dict:
    """Paired epoch/monotonic reading: lets a merger translate another
    host's monotonic timestamps onto a shared epoch timeline."""
    return {"epoch_s": time.time(), "monotonic_s": time.monotonic()}


class MetricsRegistry:
    """Name -> Counter/Histogram store with JSON snapshot export.

    All metrics share the registry's one **reentrant** lock:
    ``snapshot()`` holds it across the whole read, so the exported
    counters and histogram states form a single consistent cut — a
    snapshot taken mid-burst never observes one counter ahead of another
    that the same operation bumps.  Individual ``inc``/``observe``
    calls re-acquire the same lock reentrantly, keeping the hot-path
    cost one lock acquisition as before.
    """

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.RLock()

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(
                    name, Counter(lock=self._lock)
                )
        return c

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(lock=self._lock)
                )
        return h

    def snapshot(self, *, reservoir: bool = False,
                 host: dict | None = None) -> dict:
        """One atomic, self-describing snapshot of every metric.

        ``reservoir=True`` exports histogram reservoir samples (for
        cross-host percentile merges); ``host`` overrides fields of the
        attached :func:`host_identity` stamp.
        """
        with self._lock:
            return {
                "ts": time.time(),
                "host": host_identity(host),
                "clock": _clock_anchor(),
                "counters": {
                    k: c.value for k, c in sorted(self._counters.items())
                },
                "histograms": {
                    k: h.to_json(reservoir=reservoir)
                    for k, h in sorted(self._histograms.items())
                },
            }

    def export_jsonl(self, path: str, *, reservoir: bool = False,
                     host: dict | None = None) -> dict:
        """Append one snapshot line to ``path``; returns the snapshot."""
        snap = self.snapshot(reservoir=reservoir, host=host)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(snap) + "\n")
        return snap

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._histograms.clear()


# ---------------------------------------------------------------------------
# The process-wide registry.
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    return _REGISTRY


def reset_metrics() -> None:
    """Clear every process-wide metric (test isolation)."""
    _REGISTRY.reset()


def tuner_tier_rates(registry: MetricsRegistry | None = None) -> dict:
    """Per-tier decision fractions — the ``hit_rate`` scalar, itemized."""
    reg = registry or _REGISTRY
    total = reg.counter("tuner/decisions").value
    tiers = ("cache", "analytic", "measured", "heuristic")
    if not total:
        return {t: 0.0 for t in tiers}
    return {
        t: reg.counter(f"tuner/pick.{t}").value / total for t in tiers
    }


def observe_gate_agreement(
    grid, *, gate=None, tau=None, registry: MetricsRegistry | None = None
) -> float:
    """Heuristic-pick agreement rate against the grid's analytic argmin.

    Folds ``gate/agree`` / ``gate/points`` counters into the registry
    and returns this grid's rate — the live signal for "is the deployed
    gate still tracking the analytic optimum".  Opt-in (it costs one
    vectorized heuristic evaluation per grid).  ``gate`` (a
    :class:`repro_torch.learn.gate.LearnedGate`) evaluates the heuristic
    with the learned threshold family.
    """
    # Lazy: the core imports this package (its engine reports here).
    from repro_torch.core.explorer import GridExploration

    ex = GridExploration.from_grid(grid, tau=tau, gate=gate)
    agree = int(ex.exact.sum())
    points = int(ex.exact.size)
    reg = registry or _REGISTRY
    reg.counter("gate/agree").inc(agree)
    reg.counter("gate/points").inc(points)
    return agree / points if points else 0.0


# ---------------------------------------------------------------------------
# Snapshot schema validation.
# ---------------------------------------------------------------------------

_HIST_FIELDS = ("count", "sum", "min", "max", "p50", "p95")


def validate_snapshot(obj) -> list[str]:
    """Structural errors in one metrics snapshot ([] == valid).

    Forward/backward compatible across the snapshot schema's growth:
    ``host``/``clock`` identity stamps and per-histogram ``reservoir``
    sample lists are validated *when present* but never required, so
    pre-fleet-merge snapshots (and minimal hand-built ones) still pass
    and new-field snapshots pass older validators structurally.
    """
    errors: list[str] = []
    if not isinstance(obj, dict):
        return [f"snapshot must be an object, got {type(obj).__name__}"]
    if not isinstance(obj.get("ts"), (int, float)):
        errors.append("missing numeric 'ts'")
    host = obj.get("host")
    if host is not None:
        if not isinstance(host, dict):
            errors.append("'host' must be an object")
        else:
            if not isinstance(host.get("hostname"), str):
                errors.append("host: no 'hostname' string")
            for field in ("pid", "host_index"):
                if field in host and not isinstance(host[field], int):
                    errors.append(f"host: {field!r} not an integer")
    clock = obj.get("clock")
    if clock is not None:
        if not isinstance(clock, dict):
            errors.append("'clock' must be an object")
        else:
            for field in ("epoch_s", "monotonic_s"):
                if field in clock and not isinstance(
                    clock[field], (int, float)
                ):
                    errors.append(f"clock: {field!r} not numeric")
    counters = obj.get("counters")
    if not isinstance(counters, dict):
        errors.append("missing 'counters' object")
    else:
        for k, v in counters.items():
            if not isinstance(v, (int, float)):
                errors.append(f"counter {k!r}: value not numeric")
    hists = obj.get("histograms")
    if not isinstance(hists, dict):
        errors.append("missing 'histograms' object")
    else:
        for k, h in hists.items():
            if not isinstance(h, dict):
                errors.append(f"histogram {k!r}: not an object")
                continue
            for field in _HIST_FIELDS:
                if not isinstance(h.get(field), (int, float)):
                    errors.append(f"histogram {k!r}: no numeric {field!r}")
            res = h.get("reservoir")
            if res is not None:
                if not isinstance(res, list) or any(
                    not isinstance(v, (int, float)) for v in res
                ):
                    errors.append(
                        f"histogram {k!r}: 'reservoir' must be a "
                        "numeric list"
                    )
    return errors


# ---------------------------------------------------------------------------
# Fleet merge: union per-host snapshots into one metrics view.
# ---------------------------------------------------------------------------


def _nearest_rank(ordered: list, q: float):
    rank = max(math.ceil(q * len(ordered)), 1) - 1
    return ordered[min(rank, len(ordered) - 1)]


def _host_key(snap: dict, fallback: int):
    host = snap.get("host")
    if isinstance(host, dict):
        return (
            host.get("hostname"), host.get("pid"), host.get("host_index")
        )
    return ("<anon>", None, fallback)


def _merge_hist(members: list[dict]) -> dict:
    """Union one histogram across hosts.

    count/sum/min/max merge exactly.  Percentiles come from the union
    of the members' reservoirs when every member exported one (exact
    while each reservoir was exact, the documented ~1/sqrt(K) sampling
    tolerance beyond); without reservoirs they fall back to a
    count-weighted average of per-host percentiles, flagged
    ``"approx": true`` so downstream consumers know the difference.
    """
    live = [h for h in members if h.get("count", 0) > 0]
    if not live:
        return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                "p50": 0.0, "p95": 0.0}
    count = sum(int(h["count"]) for h in live)
    out = {
        "count": count,
        "sum": sum(float(h["sum"]) for h in live),
        "min": min(float(h["min"]) for h in live),
        "max": max(float(h["max"]) for h in live),
    }
    if all(isinstance(h.get("reservoir"), list) and h["reservoir"]
           for h in live):
        union = sorted(
            v for h in live for v in h["reservoir"]
        )
        out["p50"] = _nearest_rank(union, 0.50)
        out["p95"] = _nearest_rank(union, 0.95)
        out["reservoir_n"] = len(union)
    else:
        out["p50"] = (
            sum(float(h["p50"]) * h["count"] for h in live) / count
        )
        out["p95"] = (
            sum(float(h["p95"]) * h["count"] for h in live) / count
        )
        out["approx"] = True
    return out


def merge_snapshots(snaps) -> dict:
    """Union per-host metrics snapshots into one fleet snapshot.

    Snapshots are cumulative per process, so when several lines carry
    the same host identity only the **latest** (max ``ts``) counts —
    feeding a whole per-host JSONL stream in is safe and idempotent
    (merging a merge of one host with itself changes nothing).
    Counters sum bit-exactly (integer addition); histograms merge per
    :func:`_merge_hist`.  The result is itself a schema-valid snapshot
    (:func:`validate_snapshot` passes) plus fleet fields
    (``merged_from``, ``hosts``) checked by
    :func:`validate_merged_snapshot`.
    """
    latest: dict = {}
    for i, snap in enumerate(snaps):
        key = _host_key(snap, i)
        prev = latest.get(key)
        if prev is None or snap.get("ts", 0) >= prev.get("ts", 0):
            latest[key] = snap
    members = list(latest.values())
    if not members:
        raise ValueError("merge_snapshots: no snapshots given")

    counters: dict = {}
    for snap in members:
        for k, v in (snap.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
    hist_names = sorted({
        k for snap in members
        for k in (snap.get("histograms") or {})
    })
    histograms = {
        name: _merge_hist([
            snap.get("histograms", {}).get(name)
            for snap in members
            if snap.get("histograms", {}).get(name) is not None
        ])
        for name in hist_names
    }
    return {
        "ts": max(float(s.get("ts", 0.0)) for s in members),
        "merged_from": [
            s.get("host") or {"hostname": "<anon>"} for s in members
        ],
        "hosts": len(members),
        "counters": dict(sorted(counters.items())),
        "histograms": histograms,
    }


def validate_merged_snapshot(obj) -> list[str]:
    """Structural errors in one merged fleet snapshot ([] == valid)."""
    errors = validate_snapshot(obj)
    if not isinstance(obj, dict):
        return errors
    if not isinstance(obj.get("hosts"), int) or obj.get("hosts", 0) < 1:
        errors.append("missing positive integer 'hosts'")
    merged_from = obj.get("merged_from")
    if not isinstance(merged_from, list) or not merged_from:
        errors.append("missing non-empty 'merged_from' list")
    else:
        for i, h in enumerate(merged_from):
            if not isinstance(h, dict):
                errors.append(f"merged_from[{i}]: not an object")
    return errors


__all__ = [
    "Counter",
    "Histogram",
    "RESERVOIR_SIZE",
    "MetricsRegistry",
    "host_identity",
    "get_metrics",
    "reset_metrics",
    "tuner_tier_rates",
    "observe_gate_agreement",
    "validate_snapshot",
    "merge_snapshots",
    "validate_merged_snapshot",
]
