"""repro_torch.learn — learned schedule heuristics + sim-to-real calibration
(port of ``repro.learn``).

The paper's headline is that static inefficiency signatures pick
bespoke FiCCO schedules (~81% on unseen scenarios); this package turns
the reproduction's engines and sharded sweeps into a training pipeline
for such policies, and closes the sim-to-real loop per deployment:

  * :mod:`repro_torch.learn.features` — vectorized per-scenario feature
    extraction (comm/compute ratio, chunked-AG inflation, CIL, OTB,
    profile imbalance/active steps, machine params) from any batch or
    GridResult.
  * :mod:`repro_torch.learn.stats`    — integer per-shard *sufficient
    statistics* that plug into ``repro_torch.sweep``'s reduce mode
    (``on_shard_grid``), so 1e6–1e7-point sweeps train gates without
    gathering a grid — and sharded training is bit-identical to
    gathered training.
  * :mod:`repro_torch.learn.gate`     — the :class:`LearnedGate` threshold
    family (a small axis-aligned tree over ``(imbalance, active_steps,
    otb, r)`` generalizing ``calibrate_serial_gate``), trained greedily
    on regret; frozen, versioned, JSON-round-trip artifacts consumed by
    ``select_schedule{,_batch}(gate=...)`` and the autotuner.
  * :mod:`repro_torch.learn.fit`      — gradient sim-to-real machine
    calibration: Adam on the differentiable torch engine fits
    ``link_bw``/``s_half``/CIL coefficients to measured schedule times
    (``Autotuner.measure`` records).
  * :mod:`repro_torch.learn.measured` — the ``"measured"`` engine
    (shortlist-only measured evaluation), registered below through the
    public ``register_engine`` extension path.

Train a skew-aware gate in three lines::

    from repro_torch.learn import sweep_stats, train_gate_from_stats
    stats, _ = sweep_stats(scenarios, machines, num_shards=64)
    gate = train_gate_from_stats(stats)   # -> select_schedule(gate=gate)
"""

from repro_torch.learn.features import (
    FEATURE_INDEX,
    FEATURE_NAMES,
    GATE_FEATURES,
    feature_matrix,
    grid_features,
    scenario_features,
)
from repro_torch.learn.stats import (
    FEATURE_EDGES,
    SCORE_EDGES,
    STATS_SCHEMA,
    GateStats,
    sweep_stats,
)
from repro_torch.learn.gate import (
    GATE_SCHEMA_VERSION,
    LearnedGate,
    clear_machine_gates,
    gate_accuracy,
    get_default_gate,
    get_machine_gate,
    load_gate,
    load_machine_gate,
    machine_family,
    refine_gate,
    save_gate,
    save_machine_gates,
    set_default_gate,
    set_machine_gate,
    train_gate,
    train_gate_from_stats,
    train_machine_gates,
)
from repro_torch.learn.fit import (
    FITTABLE_PARAMS,
    FitResult,
    FittedEngine,
    MeasuredRecord,
    fit_machine,
    load_fit,
    records_from_cache,
    save_fit,
    synthesize_records,
    variant_records_from_cache,
)
from repro_torch.learn.measured import MeasuredEngine, register_measured_engine

# Registry-extension path: the measured engine registers through the
# same public API a third-party backend would use.  Idempotent so
# re-imports never trip the collision guard.
register_measured_engine()

__all__ = [
    "FEATURE_NAMES",
    "FEATURE_INDEX",
    "GATE_FEATURES",
    "feature_matrix",
    "scenario_features",
    "grid_features",
    "STATS_SCHEMA",
    "FEATURE_EDGES",
    "SCORE_EDGES",
    "GateStats",
    "sweep_stats",
    "GATE_SCHEMA_VERSION",
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
    "FITTABLE_PARAMS",
    "MeasuredRecord",
    "FitResult",
    "FittedEngine",
    "fit_machine",
    "synthesize_records",
    "records_from_cache",
    "variant_records_from_cache",
    "save_fit",
    "load_fit",
    "MeasuredEngine",
    "register_measured_engine",
]
