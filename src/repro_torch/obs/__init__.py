"""repro_torch.obs — tracing and metrics (port of ``repro.obs``).

* :mod:`repro_torch.obs.trace` — near-zero-overhead span tracer exporting
  Chrome trace-event / Perfetto JSON (``REPRO_TRACE=path`` or
  ``trace.enable()``).
* :mod:`repro_torch.obs.metrics` — counter/histogram registry with JSONL
  snapshot export.

Both are copies of the reference's modules, in its schemas.  The
reference's ``audit``, ``signature``, ``sentinel`` and ``timeline`` serve
its tuner and come with the port's (ROADMAP A4).
"""

from __future__ import annotations

from repro_torch.obs import metrics, trace

__all__ = ["trace", "metrics"]
