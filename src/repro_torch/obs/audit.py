"""Schedule-decision audit log: persist, read back, replay, explain.

Port of ``repro.obs.audit``.  The port's log has a file name of its own,
``decisions-torch.jsonl``, beside the port's cache file, so the two
packages never append to one default log.

The autotune cache stores the *latest winner* per key; it cannot answer
"why did the serving run at 14:02 pick ``hetero_unfused_1d`` for this
GEMM, and which tier decided it?".  This module persists one JSONL
record per :meth:`Autotuner.pick`/``measure`` decision — key, tier,
schedule, modelled/measured seconds, the analytic shortlist, and (for
heuristic fallbacks) the gate consulted — beside the autotune cache, so
a serving run can be replayed and explained offline.

Enable per-tuner (``Autotuner(audit=AuditLog(path))``), process-wide
(:func:`enable_audit`), or via the environment::

    REPRO_AUTOTUNE_AUDIT=1 python serve.py        # default path
    REPRO_AUTOTUNE_AUDIT=run.jsonl python serve.py

Replay (:func:`replay`) re-runs the logged picks, in order, against a
fresh tuner with a fresh in-memory cache.  Determinism of the analytic
tier makes this exact: an ``analytic`` record re-derives the same
winner, a ``cache`` record is warm-started from the earlier record for
its key (reproducing the original hit), a ``measured`` record seeds the
replay cache with the empirical winner (wall time is not reproducible
offline, the downstream cache hits are), and a ``heuristic`` record
re-runs the static decision tree.  Skewed-profile records are verified
for schedule agreement only when the profile digest is reconstructible
(it is not — digests are one-way), so they are reported as skipped
rather than silently passed.
"""

from __future__ import annotations

import json
import os
import threading
import time

ENV_VAR = "REPRO_AUTOTUNE_AUDIT"
ENV_MAX_BYTES = "REPRO_AUTOTUNE_AUDIT_MAX_BYTES"
ENV_KEEP = "REPRO_AUTOTUNE_AUDIT_KEEP"
AUDIT_FILENAME = "decisions-torch.jsonl"
DEFAULT_KEEP = 3


def default_audit_path() -> str:
    """``decisions-torch.jsonl`` beside the autotune cache file."""
    from repro_torch.autotune.cache import default_cache_dir  # lazy: keep
    # this module importable without the autotune package resolved.

    return os.path.join(default_cache_dir(), AUDIT_FILENAME)


class AuditLog:
    """Append-only JSONL decision log with size-based rotation.

    Each :meth:`record` call appends one line and closes the file, so
    concurrent processes auditing into the same path interleave whole
    lines (POSIX O_APPEND) and a crash loses at most the in-flight
    record.

    ``max_bytes`` bounds the live file: when an append would grow it
    past the bound, the live file rolls to ``path.1`` (existing rolled
    segments shift up, the oldest beyond ``keep`` is dropped) — a week
    of serve traffic keeps at most ``(keep + 1) * max_bytes`` on disk.
    Defaults come from ``REPRO_AUTOTUNE_AUDIT_MAX_BYTES`` /
    ``REPRO_AUTOTUNE_AUDIT_KEEP`` (unset == unbounded, the historical
    behavior).  :func:`audit_segments` / :func:`read_audit_segments`
    and :func:`replay` read across rolled segments oldest-first.
    """

    def __init__(self, path: str | None = None, *,
                 max_bytes: int | None = None, keep: int | None = None):
        self.path = path or default_audit_path()
        if max_bytes is None:
            max_bytes = int(os.environ.get(ENV_MAX_BYTES, "0") or 0)
        if keep is None:
            keep = int(os.environ.get(ENV_KEEP, str(DEFAULT_KEEP))
                       or DEFAULT_KEEP)
        self.max_bytes = max(int(max_bytes), 0)  # 0 == unbounded
        self.keep = max(int(keep), 1)
        self.rotations = 0
        self._lock = threading.Lock()

    def _rotate_locked(self) -> None:
        oldest = f"{self.path}.{self.keep}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self.rotations += 1

    def record(self, rec: dict) -> None:
        rec.setdefault("ts", time.time())
        line = json.dumps(rec) + "\n"
        with self._lock:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            if self.max_bytes:
                try:
                    size = os.path.getsize(self.path)
                except OSError:
                    size = 0
                if size and size + len(line) > self.max_bytes:
                    self._rotate_locked()
            with open(self.path, "a") as f:
                f.write(line)


# ---------------------------------------------------------------------------
# Process-wide audit log (what Autotuner consults when audit=None).
# ---------------------------------------------------------------------------

_AUDIT: AuditLog | None = None


def enable_audit(path: str | None = None) -> AuditLog:
    global _AUDIT
    _AUDIT = AuditLog(path)
    return _AUDIT


def disable_audit() -> None:
    global _AUDIT
    _AUDIT = None


def get_audit() -> AuditLog | None:
    return _AUDIT


_env = os.environ.get(ENV_VAR)
if _env:  # pragma: no cover - exercised via subprocess in tests
    enable_audit(None if _env in ("1", "true") else _env)


# ---------------------------------------------------------------------------
# Reading + replay.
# ---------------------------------------------------------------------------


def audit_segments(path: str) -> list[str]:
    """Existing on-disk segments of a (possibly rotated) audit log,
    oldest-first: ``[path.N, ..., path.1, path]``."""
    rolled: list[str] = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        rolled.append(f"{path}.{i}")
        i += 1
    segments = list(reversed(rolled))
    if os.path.exists(path) or not segments:
        segments.append(path)
    return segments


def read_audit_segments(path: str) -> list[dict]:
    """Parse a rotated audit log across all its segments, in record
    order (oldest rolled segment first, live file last)."""
    records: list[dict] = []
    for seg in audit_segments(path):
        if os.path.exists(seg):
            records.extend(read_audit(seg))
    return records


def read_audit(path: str) -> list[dict]:
    """Parse a JSONL audit file; raises ValueError on a malformed line."""
    records: list[dict] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
            if not isinstance(rec, dict):
                raise ValueError(f"{path}:{i + 1}: record not an object")
            records.append(rec)
    return records


_PICK_FIELDS = ("machine", "group", "m", "n", "k", "dtype_bytes")


# Non-decision record kinds that legitimately share the audit stream:
# the serving tier's budgeted measured sessions and the drift
# sentinel's typed events (validated in depth by
# ``repro_torch.obs.sentinel.validate_sentinel``) — structurally they only
# need a numeric timestamp here.
_AUX_KINDS = ("adapt_measure",)
_AUX_PREFIXES = ("sentinel_",)


def validate_audit(records: list[dict]) -> list[str]:
    """Structural errors in audit records ([] == valid)."""
    errors: list[str] = []
    for i, rec in enumerate(records):
        kind = rec.get("kind")
        if kind in _AUX_KINDS or (
            isinstance(kind, str) and kind.startswith(_AUX_PREFIXES)
        ):
            if not isinstance(rec.get("ts"), (int, float)):
                errors.append(f"record[{i}] ({kind}): no numeric 'ts'")
            continue
        if kind not in ("pick", "measure"):
            errors.append(f"record[{i}]: unknown kind {kind!r}")
            continue
        if not isinstance(rec.get("schedule"), str):
            errors.append(f"record[{i}]: no schedule string")
        if rec.get("source") not in (
            "cache", "analytic", "measured", "heuristic"
        ):
            errors.append(f"record[{i}]: bad source {rec.get('source')!r}")
        for field in _PICK_FIELDS:
            if not isinstance(rec.get(field), (int, str)):
                errors.append(f"record[{i}]: missing {field!r}")
    return errors


class ReplayResult:
    """Outcome of replaying an audit log against a fresh tuner."""

    def __init__(self):
        self.total = 0
        self.replayed = 0
        self.matched = 0
        self.mismatches: list[dict] = []
        self.skipped: list[dict] = []

    @property
    def ok(self) -> bool:
        return self.replayed > 0 and not self.mismatches

    def to_json(self) -> dict:
        return {
            "total": self.total,
            "replayed": self.replayed,
            "matched": self.matched,
            "ok": self.ok,
            "mismatches": self.mismatches,
            "skipped": self.skipped,
        }


def replay(records, *, backend: str = "numpy") -> ReplayResult:
    """Re-derive every logged decision; report agreement per record.

    ``records`` is a path or an iterable of parsed records.  The replay
    tuner starts from an *empty, non-persisted* cache so replay never
    touches (or is influenced by) the live store; ``backend`` defaults
    to the numpy engine so replay needs no accelerator.
    """
    from repro_torch.autotune.cache import AutotuneCache
    from repro_torch.autotune.tuner import Autotuner
    from repro_torch.core.machine import MACHINES
    from repro_torch.core.schedule_types import Schedule
    from repro_torch.core.workload import GemmShape

    if isinstance(records, str):
        records = read_audit_segments(records)

    cache = AutotuneCache(path=os.devnull)
    cache.entries = {}
    # audit=False: replaying an audited process must not append the
    # replayed picks back onto the live log.
    tuner = Autotuner(cache, backend=backend, persist=False, audit=False)
    result = ReplayResult()

    for i, rec in enumerate(records):
        result.total += 1
        kind = rec.get("kind")
        if kind in _AUX_KINDS or (
            isinstance(kind, str) and kind.startswith(_AUX_PREFIXES)
        ):
            result.skipped.append(
                {"index": i, "reason": f"non-decision kind {kind!r}"}
            )
            continue
        machine = MACHINES.get(rec.get("machine"))
        if machine is None:
            result.skipped.append(
                {"index": i, "reason": f"unknown machine {rec.get('machine')!r}"}
            )
            continue
        group = int(rec["group"])
        profile = rec.get("profile", f"u{group}")
        if profile != f"u{group}":
            # Skewed profiles are keyed by a one-way digest; the step
            # decomposition cannot be reconstructed from the log.
            result.skipped.append(
                {"index": i, "reason": f"non-uniform profile {profile!r}"}
            )
            continue
        gemm = GemmShape(
            int(rec["m"]), int(rec["n"]), int(rec["k"]),
            int(rec["dtype_bytes"]),
        )
        expect_sched = rec["schedule"]
        expect_source = rec["source"]
        key = rec.get("key")

        if rec.get("kind") == "measure" or expect_source == "measured":
            # Wall time is not reproducible offline; seed the replay
            # cache with the empirical winner so downstream cache-tier
            # records for this key replay against the same state the
            # original process had.
            if key:
                cache.put(
                    key,
                    {"schedule": expect_sched, "source": "measured"},
                    persist=False,
                )
            result.skipped.append(
                {"index": i, "reason": "measured record (seeded cache)"}
            )
            continue
        if expect_source == "cache" and key and key not in cache:
            # The original process was warm-started by an earlier run;
            # reproduce that state from the record itself.
            cache.put(
                key,
                {"schedule": expect_sched, "source": "analytic"},
                persist=False,
            )
        if expect_source == "heuristic":
            # The fallback fired because a model/backend failure occurred
            # in the original process; what is reproducible offline is
            # the static decision tree's choice.
            from repro_torch.core.heuristics import select_schedule
            from repro_torch.core.machine import machine_for_group

            eff = (
                machine_for_group(machine, group)
                if group != machine.group else machine
            )
            got = select_schedule(gemm, eff)
            got_sched, got_source = got.schedule, "heuristic"
        else:
            dec = tuner.pick(gemm, machine, group=group)
            got_sched, got_source = dec.schedule, dec.source

        result.replayed += 1
        if got_sched is Schedule(expect_sched) and got_source == expect_source:
            result.matched += 1
        else:
            result.mismatches.append({
                "index": i,
                "key": key,
                "expected": {"schedule": expect_sched, "source": expect_source},
                "got": {"schedule": got_sched.value, "source": got_source},
            })
    return result


__all__ = [
    "ENV_VAR",
    "ENV_MAX_BYTES",
    "ENV_KEEP",
    "AUDIT_FILENAME",
    "AuditLog",
    "default_audit_path",
    "enable_audit",
    "disable_audit",
    "get_audit",
    "audit_segments",
    "read_audit",
    "read_audit_segments",
    "validate_audit",
    "ReplayResult",
    "replay",
]
