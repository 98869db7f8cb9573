"""Persistent on-disk cache for tuned schedule decisions.

Port of ``repro.autotune.cache``.  One JSON file per schema version,
stamped with the torch version, the CUDA version and the device name
(where the reference stamps jax's version): tuned decisions survive
processes, so the first process pays the analytic-model (or measured)
tuning cost and every later launcher/server starts with the winner.

Layout (human-readable on purpose — this is an operational artifact)::

    {
      "schema": 2,
      "torch": "2.6.0+cu124",
      "cuda": "12.4",                    # null for a CPU-only torch
      "device": "NVIDIA H100 80GB HBM3", # "cpu" without a CUDA device
      "entries": {
        "h100-sxm-8/g4/m2048/n5632/k2048/b2/u4": {
          "schedule": "serial",
          "source": "measured",          # analytic | measured
          "model_total_s": null,         # analytic model's time for it
          "measured_total_s": 0.000108,  # device time when source=measured
        },
        ...
      }
    }

The keys are the reference's (schema v2: ``machine/gG/mM/nN/kK/bB`` plus
the step-profile digest, ``/u16`` for the uniform 16-step split), so a
decision reads the same in both packages.  The file has a name of its
own, ``autotune-torch-v2.json``: the reference's ``autotune-v2.json``
treats a foreign stamp as empty and its merge-on-save then drops the
other package's entries, so sharing one path would let two processes
wipe each other's caches.

Location: ``$REPRO_AUTOTUNE_CACHE_DIR`` if set, else
``~/.cache/repro_autotune`` (the reference's directory).  The test suite
sets the env var to a tmp dir (see ``tests/conftest.py``) so tier-1 runs
never touch — or get polluted by — the user's home cache.

Writes are atomic (tempfile + ``os.replace``) and loads are tolerant: a
corrupt or stamp-mismatched file is treated as empty, never an error —
the cache is an accelerator, not a source of truth.

Concurrency + hot-path persistence:

* Every mutation and ``save()`` holds a per-instance re-entrant lock,
  so a background thread writing artifacts can never race a serving
  thread's ``put`` into a lost entry (``save`` snapshots, merges and
  swaps ``entries`` under the same lock the writers take).
* ``put(..., persist="defer")`` marks the store dirty instead of
  rewriting the whole JSON file — the eager ``persist=True`` path is
  O(store) disk I/O *per decision*, which is exactly what the serving
  hot path must not pay.  Deferred writes flush on ``flush()``, and
  every dirty cache still alive at interpreter exit is flushed by an
  ``atexit`` hook (best-effort: a flush into a vanished temp dir is
  swallowed).  Merge-on-save semantics are identical on both paths.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import tempfile
import threading
import weakref
from typing import Any

import torch

SCHEMA_VERSION = 2  # v2: ragged step-profile digest joined the key schema
_ENV_VAR = "REPRO_AUTOTUNE_CACHE_DIR"

# Artifact segment: non-decision payloads (promoted kernel variants,
# learned gates) share the store under a reserved key prefix.  TuneKey
# strings always start with a machine name segment, never this prefix, so
# tuner lookups and artifact lookups can never collide.
ARTIFACT_PREFIX = "__artifact__"


def artifact_key(kind: str, name: str) -> str:
    return f"{ARTIFACT_PREFIX}/{kind}/{name}"


def _stamp() -> dict[str, Any]:
    """What invalidates the file wholesale: the torch and CUDA versions and
    the device a measured decision was timed on."""
    device = (
        torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    )
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": device,
    }


def default_cache_dir() -> str:
    """$REPRO_AUTOTUNE_CACHE_DIR, else ~/.cache/repro_autotune."""
    env = os.environ.get(_ENV_VAR)
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_autotune"
    )


def default_cache_path() -> str:
    return os.path.join(
        default_cache_dir(), f"autotune-torch-v{SCHEMA_VERSION}.json"
    )


def _read_entries(path: str) -> dict[str, Any] | None:
    """Entries in the backing file, or None if absent/corrupt/stale."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(raw, dict):
        return None
    if raw.get("schema") != SCHEMA_VERSION:
        return None
    if any(raw.get(k) != v for k, v in _stamp().items()):
        return None  # a new torch, CUDA or card invalidates them wholesale
    entries = raw.get("entries")
    if not isinstance(entries, dict):
        return None
    return {k: v for k, v in entries.items() if isinstance(v, dict)}


# Caches holding deferred (unflushed) writes; flushed best-effort at
# interpreter exit.  A WeakSet so registration never extends a cache's
# lifetime — a collected cache simply loses its unflushed writes, the
# same contract an abrupt process death has always had.
_DIRTY_CACHES: "weakref.WeakSet[AutotuneCache]" = weakref.WeakSet()


@atexit.register
def _flush_dirty_caches() -> None:
    for cache in list(_DIRTY_CACHES):
        try:
            cache.flush()
        except Exception:
            pass  # exit-time best effort (tmp dir may be gone)


@dataclasses.dataclass(eq=False)  # identity semantics: hashable for the
class AutotuneCache:              # dirty-cache WeakSet
    """Versioned persistent key -> tuned-decision store.

    Keys are produced by :class:`repro_torch.autotune.tuner.TuneKey` and
    embed the machine name + group, so one file safely holds entries for
    many machines; the torch and CUDA versions and the device name stamp
    the whole file (any of them can change what the measured path runs
    at, so tuned decisions are invalidated wholesale — re-tuning is
    cheap).
    """

    path: str | None = None
    entries: dict[str, dict[str, Any]] = dataclasses.field(
        default_factory=dict
    )
    _loaded_from_disk: bool = False
    _lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False
    )
    _dirty: bool = dataclasses.field(default=False, repr=False,
                                     compare=False)

    def __post_init__(self):
        if self.path is None:
            self.path = default_cache_path()
        self.load()

    # -- persistence ----------------------------------------------------

    def load(self) -> None:
        """Read the backing file; silently start empty on any mismatch."""
        entries = _read_entries(self.path)
        with self._lock:
            self.entries = entries if entries is not None else {}
            self._loaded_from_disk = entries is not None
            self._dirty = False

    def save(self) -> None:
        """Atomic write (tempfile + rename) of the whole store.

        Merge-on-save: entries another process persisted since our load
        are folded in first (ours win on key collision), so concurrent
        processes tuning disjoint keys don't clobber each other — the
        union survives, whoever writes last.  The merge + swap + write
        happens under the instance lock, so a ``put`` racing from
        another thread either lands before the snapshot (persisted now)
        or after the swap (persisted by the next flush) — never lost
        mid-``save``.
        """
        with self._lock:
            merged = {**(_read_entries(self.path) or {}), **self.entries}
            self.entries = merged
            self._dirty = False
            _DIRTY_CACHES.discard(self)
            d = os.path.dirname(self.path)
            os.makedirs(d, exist_ok=True)
            payload = {
                "schema": SCHEMA_VERSION,
                **_stamp(),
                "entries": merged,
            }
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    def flush(self) -> None:
        """Persist deferred writes, if any (no-op on a clean store)."""
        with self._lock:
            if self._dirty:
                self.save()

    @property
    def dirty(self) -> bool:
        """True when deferred writes await a ``flush()``."""
        return self._dirty

    def clear(self) -> None:
        with self._lock:
            self.entries = {}
            self._dirty = False
            _DIRTY_CACHES.discard(self)
            try:
                os.unlink(self.path)
            except OSError:
                pass

    # -- access ---------------------------------------------------------

    def get(self, key: str) -> dict[str, Any] | None:
        with self._lock:
            return self.entries.get(key)

    def put(
        self,
        key: str,
        entry: dict[str, Any],
        *,
        persist: bool | str = True,
    ) -> None:
        """Record one entry.

        ``persist`` is ``True`` (write the whole store now — the
        pre-existing O(store) behavior), ``False`` (in-memory only), or
        ``"defer"`` (mark dirty; persisted by the next ``flush()`` /
        ``save()`` or the atexit hook — the serving hot path's choice).
        """
        if persist not in (True, False, "defer"):
            raise ValueError(
                f"persist must be True, False or 'defer', got {persist!r}"
            )
        with self._lock:
            self.entries[key] = entry
            if persist == "defer":
                self._dirty = True
                _DIRTY_CACHES.add(self)
            elif persist:
                self.save()

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    # -- artifact segment (promoted variants, learned gates) ------------

    def put_artifact(
        self,
        kind: str,
        name: str,
        payload: dict[str, Any],
        *,
        persist: bool | str = True,
    ) -> None:
        """Store a non-decision artifact (e.g. a promoted kernel variant).

        Artifacts live in the same versioned file under the reserved
        ``__artifact__/`` key prefix, so they inherit the cache's
        atomic-write, merge-on-save and schema/stamp invalidation
        behavior for free.
        """
        self.put(artifact_key(kind, name), payload, persist=persist)

    def get_artifact(self, kind: str, name: str) -> dict[str, Any] | None:
        return self.get(artifact_key(kind, name))

    def artifact_names(self, kind: str) -> tuple[str, ...]:
        prefix = f"{ARTIFACT_PREFIX}/{kind}/"
        with self._lock:
            return tuple(
                sorted(
                    k[len(prefix):]
                    for k in self.entries
                    if k.startswith(prefix)
                )
            )

    def decision_entries(self) -> dict[str, dict[str, Any]]:
        """Tuned-decision entries only (artifact segment filtered out)."""
        with self._lock:
            return {
                k: v
                for k, v in self.entries.items()
                if not k.startswith(f"{ARTIFACT_PREFIX}/")
            }


__all__ = [
    "SCHEMA_VERSION",
    "ARTIFACT_PREFIX",
    "artifact_key",
    "AutotuneCache",
    "default_cache_dir",
    "default_cache_path",
]
