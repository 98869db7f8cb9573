"""Near-zero-overhead span tracer -> Chrome trace-event / Perfetto JSON.

Port of ``repro.obs.trace`` (a copy: the port imports nothing of
``repro``).  A :class:`Tracer` collects trace events in memory and exports
them in the Chrome trace-event format (the JSON ``chrome://tracing`` and
https://ui.perfetto.dev load directly).  The port's instrumented sites are
the serve engine (``serve/run``, ``serve/step``), the train loop
(``train/step``) and the schedule resolution (``overlap/resolve``), with
the reference's names and args, so a trace of either package reads the
same.

Disabled is the default and costs one module-global read per
instrumentation site: :func:`span` returns a shared no-op context
manager when no tracer is installed.

Enable via the API::

    from repro_torch.obs import trace
    trace.enable("run.trace.json")      # path optional: export() later
    ... instrumented work ...
    trace.disable()                     # exports to the path, returns it

or via the environment, with the reference's variable: ``REPRO_TRACE=path``
turns tracing on at import and registers an ``atexit`` export::

    REPRO_TRACE=train.trace.json python -m repro_torch.launch.train ...
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time

ENV_VAR = "REPRO_TRACE"


class _NullSpan:
    """Shared do-nothing span: what :func:`span` returns when disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        """Attach args to the span (no-op when disabled)."""


NULL_SPAN = _NullSpan()


class _Span:
    """One open duration ("X") event; closes on ``__exit__``."""

    __slots__ = ("_tracer", "name", "cat", "pid", "tid", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 pid: int, tid: int, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.pid = pid
        self.tid = tid
        self.args = args
        self._t0 = 0.0

    def set(self, **args) -> None:
        """Attach/overwrite args (e.g. the decision once it's known)."""
        self.args.update(args)

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer._now_us()
        self._tracer._append({
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": self._t0,
            "dur": t1 - self._t0,
            "pid": self.pid,
            "tid": self.tid,
            "args": self.args,
        })
        return False


class Tracer:
    """In-memory trace-event collector with Chrome-JSON export.

    Timestamps are microseconds relative to tracer creation
    (``perf_counter`` based — monotonic, sub-microsecond resolution).
    Appends are a single list.append under the GIL, so spans opened from
    side threads (e.g. a background re-fit thread) interleave safely.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._named: set[tuple] = set()
        self._t0 = time.perf_counter()
        # Epoch anchor of ts==0: what lets merge_traces place this
        # tracer's relative timestamps on a cross-host timeline.
        self._epoch0 = time.time()

    # -- low-level event plumbing --------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _append(self, event: dict) -> None:
        self.events.append(event)  # atomic under the GIL

    # -- event emitters -------------------------------------------------

    def span(self, name: str, cat: str = "repro", *,
             pid: int = 1, tid: int = 0, **args) -> _Span:
        """Open a duration span (context manager)."""
        return _Span(self, name, cat, pid, tid, args)

    def instant(self, name: str, cat: str = "repro", *,
                pid: int = 1, tid: int = 0, **args) -> None:
        self._append({
            "name": name, "cat": cat, "ph": "i", "ts": self._now_us(),
            "s": "t", "pid": pid, "tid": tid, "args": args,
        })

    def counter(self, name: str, value: float, *,
                cat: str = "repro", pid: int = 1) -> None:
        """Emit a Chrome counter ("C") sample (renders as a track graph)."""
        self._append({
            "name": name, "cat": cat, "ph": "C", "ts": self._now_us(),
            "pid": pid, "tid": 0, "args": {"value": value},
        })

    def name_process(self, pid: int, name: str) -> None:
        key = ("p", pid)
        if key in self._named:
            return
        self._named.add(key)
        self._append({
            "name": "process_name", "ph": "M", "ts": 0.0,
            "pid": pid, "tid": 0, "args": {"name": name},
        })

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        key = ("t", pid, tid)
        if key in self._named:
            return
        self._named.add(key)
        self._append({
            "name": "thread_name", "ph": "M", "ts": 0.0,
            "pid": pid, "tid": tid, "args": {"name": name},
        })

    # -- export ---------------------------------------------------------

    def to_json(self) -> dict:
        from repro_torch.obs.metrics import host_identity  # lazy, as
        # in the reference: this runs long after import.

        with self._lock:
            events = list(self.events)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "host": host_identity(),
            "clock": {"epoch0_s": self._epoch0},
        }

    def export(self, path: str | None = None) -> str:
        """Write the Chrome trace JSON; returns the path written."""
        path = path or self.path
        if not path:
            raise ValueError("no export path: pass one or set tracer.path")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path


# ---------------------------------------------------------------------------
# The process-wide tracer (what the instrumentation sites consult).
# ---------------------------------------------------------------------------

_TRACER: Tracer | None = None


def enable(path: str | None = None) -> Tracer:
    """Install a process-wide tracer (``path`` is the default export)."""
    global _TRACER
    _TRACER = Tracer(path)
    return _TRACER


def disable() -> str | None:
    """Uninstall the tracer; exports first if it has a path.

    Returns the exported path (None if nothing was exported).
    """
    global _TRACER
    t, _TRACER = _TRACER, None
    if t is not None and t.path:
        return t.export()
    return None


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Tracer | None:
    return _TRACER


def span(name: str, cat: str = "repro", *,
         pid: int = 1, tid: int = 0, **args):
    """Span against the process tracer; the shared no-op when disabled.

    The disabled path is one global read + returning a singleton whose
    ``__enter__``/``__exit__`` do nothing — cheap enough for every
    instrumentation site in the repo to call unconditionally.
    """
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, cat, pid=pid, tid=tid, **args)


def instant(name: str, cat: str = "repro", **args) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, cat, **args)


def counter(name: str, value: float, *, cat: str = "repro") -> None:
    t = _TRACER
    if t is not None:
        t.counter(name, value, cat=cat)


# ---------------------------------------------------------------------------
# Schema validation (what the CI fast lane gates exported artifacts with).
# ---------------------------------------------------------------------------

_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def validate_trace(obj) -> list[str]:
    """Structural errors in a Chrome-trace JSON object ([] == valid).

    Checks the invariants Perfetto's importer relies on: a
    ``traceEvents`` list whose entries carry name/ph/ts/pid/tid, with a
    non-negative ``dur`` on every complete ("X") event.
    """
    errors: list[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event[{i}]: not an object")
            continue
        for field in _REQUIRED:
            if field not in ev:
                errors.append(f"event[{i}] ({ev.get('name')}): no {field!r}")
        if not isinstance(ev.get("name"), str):
            errors.append(f"event[{i}]: name must be a string")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"event[{i}] ({ev.get('name')}): ts not numeric")
        if ev.get("ph") == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"event[{i}] ({ev.get('name')}): X event needs dur >= 0"
                )
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"event[{i}] ({ev.get('name')}): args not a dict")
        if len(errors) > 50:
            errors.append("... (truncated)")
            break
    return errors


# ---------------------------------------------------------------------------
# Fleet merge: several hosts' exports -> one Perfetto timeline.
# ---------------------------------------------------------------------------

# Per-host pid stride in a merged trace: host i's original pid p becomes
# i * _MERGE_PID_STRIDE + p, so process tracks from different hosts
# never collide in the merged view (in-repo tracers use single-digit
# pids).
_MERGE_PID_STRIDE = 10_000


def merge_traces(traces) -> dict:
    """Union per-host Chrome-trace exports onto one timeline.

    Each input is a parsed ``Tracer.to_json()`` object.  Timestamps are
    tracer-relative microseconds; the per-export ``clock.epoch0_s``
    anchor (absent on pre-fleet-merge exports — those merge at offset
    0) shifts every host onto the earliest tracer's clock, and pids are
    namespaced per host (stride :data:`_MERGE_PID_STRIDE`) with a
    ``process_name`` metadata row labelling the host, so the merged
    JSON opens in Perfetto as one timeline with per-host process
    groups.  The result revalidates under :func:`validate_trace`.
    """
    traces = list(traces)
    if not traces:
        raise ValueError("merge_traces: no traces given")
    anchors = []
    for t in traces:
        clock = t.get("clock") if isinstance(t, dict) else None
        anchors.append(
            float(clock["epoch0_s"])
            if isinstance(clock, dict)
            and isinstance(clock.get("epoch0_s"), (int, float))
            else None
        )
    known = [a for a in anchors if a is not None]
    base = min(known) if known else 0.0

    merged: list[dict] = []
    hosts: list[dict] = []
    for i, t in enumerate(traces):
        events = t.get("traceEvents") or []
        host = t.get("host") if isinstance(t.get("host"), dict) else {}
        hosts.append(host or {"hostname": f"trace{i}"})
        offset_us = (
            (anchors[i] - base) * 1e6 if anchors[i] is not None else 0.0
        )
        label = "{}#{}".format(
            host.get("hostname", f"trace{i}"), host.get("host_index", i)
        )
        seen_pids: set = set()
        for ev in events:
            ev = dict(ev)
            pid = ev.get("pid", 0)
            ev["pid"] = i * _MERGE_PID_STRIDE + (
                pid if isinstance(pid, int) else 0
            )
            if ev.get("ph") != "M":
                ev["ts"] = float(ev.get("ts", 0.0)) + offset_us
            elif ev.get("name") == "process_name":
                # Prefix the original process name with the host label
                # so per-host groups read apart in the merged view.
                args = dict(ev.get("args") or {})
                args["name"] = f"{label} | {args.get('name', '')}"
                ev["args"] = args
            seen_pids.add(ev["pid"])
            merged.append(ev)
        # Hosts whose events never named their processes still get a
        # labelled track.
        named = {
            e["pid"] for e in merged
            if e.get("ph") == "M" and e.get("name") == "process_name"
        }
        for pid in sorted(seen_pids - named):
            merged.append({
                "name": "process_name", "ph": "M", "ts": 0.0,
                "pid": pid, "tid": 0, "args": {"name": label},
            })
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "merged_from": hosts,
        "clock": {"epoch0_s": base},
    }


# ---------------------------------------------------------------------------
# Environment hook: REPRO_TRACE=path enables at import, exports at exit.
# ---------------------------------------------------------------------------


def _export_at_exit() -> None:  # pragma: no cover - atexit plumbing
    t = _TRACER
    if t is not None and t.path:
        try:
            t.export()
        except OSError:
            pass


_env = os.environ.get(ENV_VAR)
if _env:  # pragma: no cover - reloaded under the variable in tests
    enable(None if _env in ("1", "true") else _env)
    atexit.register(_export_at_exit)


__all__ = [
    "ENV_VAR",
    "Tracer",
    "NULL_SPAN",
    "enable",
    "disable",
    "enabled",
    "get_tracer",
    "span",
    "instant",
    "counter",
    "validate_trace",
    "merge_traces",
]
