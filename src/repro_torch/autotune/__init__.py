"""repro_torch.autotune — the runtime schedule autotuner (port of
``repro.autotune``).

* :mod:`repro_torch.autotune.tuner` — tiered runtime selection:
  persistent cache hit -> analytic model -> optional measured shortlist,
  timed on the card with CUDA events.
* :mod:`repro_torch.autotune.cache` — versioned on-disk JSON store
  (``$REPRO_AUTOTUNE_CACHE_DIR``, default ``~/.cache/repro_autotune``,
  file ``autotune-torch-v2.json``).
* :mod:`repro_torch.autotune.torchgrid` — the grid engine on the card
  (the reference's ``jaxgrid``): float64 tensor math over every machine
  at once, differentiable by autograd (``calibrate_tau``, the machine fit
  of ``repro_torch.learn.fit``), registered as the ``"torch"`` engine.
  Imported lazily: importing this package launches nothing.

The runtime entry point is ``ficco_linear(schedule="autotune")`` (see
``repro_torch.overlap.api``), with ``select_schedule`` as the zero-cost
static fallback.
"""

from repro_torch.autotune.cache import (
    SCHEMA_VERSION,
    AutotuneCache,
    default_cache_dir,
    default_cache_path,
)
from repro_torch.autotune.tuner import (
    Autotuner,
    TuneDecision,
    TuneKey,
    autotune_schedule,
    get_tuner,
    machine_for_group,
    reset_tuner,
    set_tuner,
)

__all__ = [
    "SCHEMA_VERSION",
    "AutotuneCache",
    "default_cache_dir",
    "default_cache_path",
    "Autotuner",
    "TuneDecision",
    "TuneKey",
    "autotune_schedule",
    "get_tuner",
    "set_tuner",
    "reset_tuner",
    "machine_for_group",
]
