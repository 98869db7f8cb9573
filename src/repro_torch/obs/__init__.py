"""repro_torch.obs — tracing, metrics and schedule-decision provenance
(port of ``repro.obs``).

* :mod:`repro_torch.obs.trace` — near-zero-overhead span tracer exporting
  Chrome trace-event / Perfetto JSON (``REPRO_TRACE=path`` or
  ``trace.enable()``).
* :mod:`repro_torch.obs.metrics` — counter/histogram registry with JSONL
  snapshot export (tuner tier rates, gate agreement).
* :mod:`repro_torch.obs.audit` — per-decision provenance records persisted
  beside the autotune cache, replayable offline
  (``REPRO_AUTOTUNE_AUDIT=path`` or ``Autotuner(audit=...)``).
* :mod:`repro_torch.obs.timeline` — any simulated schedule rendered as a
  per-step comm/GEMM/DMA lane trace with its inefficiency signature.
* :mod:`repro_torch.obs.signature` — the signature as a *streaming*
  observable: every tuner decision decomposed into the paper's loss
  categories and accumulated per (machine family, scenario class,
  schedule) (``REPRO_SIGNATURES=path`` or
  ``signature.enable_signatures()``).
* :mod:`repro_torch.obs.sentinel` — the drift sentinel: EWMA/CUSUM over
  the serving tier's predicted-vs-measured residuals and its gate
  agreement, with typed alarm / refit / recovery events.

All are copies of the reference's modules, in its schemas.

This ``__init__`` stays light: the instrumented modules
(``repro_torch.core.engine``, the tuner) import ``repro_torch.obs.trace``
at their own import time, which executes this file — pulling
``repro_torch.core`` back in here would be a cycle.  ``timeline`` (which
needs the simulator), ``signature`` and ``sentinel`` are therefore
exported lazily (PEP 562).
"""

from __future__ import annotations

from repro_torch.obs import audit, metrics, trace

_LAZY = {"timeline", "signature", "sentinel"}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return importlib.import_module(f"repro_torch.obs.{name}")
    raise AttributeError(
        f"module 'repro_torch.obs' has no attribute {name!r}"
    )


__all__ = ["trace", "metrics", "audit", "timeline", "signature", "sentinel"]
