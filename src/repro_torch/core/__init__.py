"""FiCCO core: the paper's contribution as a composable library (port of
``repro.core``, NumPy on the host, bit for bit the reference's numbers).

Layers:
  * machine / workload  — hardware + operator descriptors (Table I included;
                          :data:`H100_SXM` beside the reference's machines)
  * inefficiency        — DIL / CIL analytic models (§IV), paper-calibrated
  * schedule_types      — the design space (Fig. 11a)
  * simulator           — two-channel discrete schedule simulator (Fig. 11b)
  * engine              — unified Engine protocol + backend registry
  * batch               — NumPy-vectorized batched grid engine (S x M x L)
  * heuristics          — static OTB x MT schedule selection (Fig. 12a)
  * explorer            — full design-space exploration + pruning argument

Sweeping a design space takes three lines::

    from repro_torch.core import TABLE_I, MI300X, TPU_V5E, explore_grid
    ex = explore_grid(TABLE_I, machines=[MI300X, TPU_V5E])
    print(ex.summary())   # accuracy + losses over all schedules at once

The ``"torch"`` engine (:class:`TorchEngine`, float64 tensor math on the
card through :mod:`repro_torch.autotune.torchgrid`) takes the reference's
jitted ``"jax"`` engine's role; the learned gate lives in
:mod:`repro_torch.learn`.
"""

from repro_torch.core.machine import (
    H100_SXM,
    MACHINES,
    MI300X,
    TPU_V5E,
    MachineSpec,
    Topology,
    machine_for_group,
)
from repro_torch.core.workload import (
    SCENARIOS,
    TABLE_I,
    CollectiveKind,
    GemmShape,
    RaggedScenario,
    Scenario,
    StepProfile,
    geomean,
    machine_grid,
    ragged_scenario_grid,
    scenario_grid,
    synthetic_scenarios,
)
from repro_torch.core.schedule_types import (
    ALL_VARIANTS,
    SIGNATURES,
    STUDIED,
    CommShape,
    FiccoVariant,
    Granularity,
    Schedule,
    Uniformity,
)
from repro_torch.core.inefficiency import (
    GemmExec,
    a2a_chunk_step_time,
    ag_serial_time,
    comm_cil,
    gemm_cil,
    gemm_dil,
    gemm_exec,
    gemm_time_decomposed,
    p2p_step_time,
)
from repro_torch.core.simulator import SimResult, best_schedule, simulate
from repro_torch.core.engine import (
    GRID_SCHEDULES,
    Engine,
    GridResult,
    NumpyEngine,
    TorchEngine,
    ScalarEngine,
    engine_names,
    get_engine,
    register_engine,
)
from repro_torch.core.batch import (
    RaggedBatch,
    ScenarioBatch,
    evaluate_grid,
    evaluate_ragged_grid,
)
from repro_torch.core.heuristics import (
    HeuristicDecision,
    calibrate_serial_gate,
    calibrate_tau,
    machine_serial_gate,
    machine_threshold,
    select_schedule,
    select_schedule_batch,
    serial_gate_score,
    serial_gate_score_batch,
    serial_gate_terms_batch,
)
from repro_torch.core.explorer import (
    Exploration,
    GridExploration,
    explore,
    explore_grid,
    prune_report,
)

__all__ = [
    "H100_SXM", "MACHINES", "MI300X", "TPU_V5E", "MachineSpec", "Topology",
    "machine_for_group",
    "SCENARIOS", "TABLE_I", "CollectiveKind", "GemmShape", "RaggedScenario",
    "Scenario", "StepProfile",
    "geomean", "machine_grid", "ragged_scenario_grid", "scenario_grid",
    "synthetic_scenarios",
    "ALL_VARIANTS", "SIGNATURES", "STUDIED", "CommShape", "FiccoVariant",
    "Granularity", "Schedule", "Uniformity",
    "GemmExec", "a2a_chunk_step_time", "ag_serial_time", "comm_cil",
    "gemm_cil", "gemm_dil", "gemm_exec", "gemm_time_decomposed",
    "p2p_step_time",
    "SimResult", "best_schedule", "simulate",
    "GRID_SCHEDULES", "GridResult", "RaggedBatch", "ScenarioBatch",
    "evaluate_grid", "evaluate_ragged_grid",
    "Engine", "ScalarEngine", "NumpyEngine", "TorchEngine",
    "engine_names", "get_engine", "register_engine",
    "HeuristicDecision", "calibrate_serial_gate", "calibrate_tau",
    "machine_serial_gate", "machine_threshold",
    "select_schedule", "select_schedule_batch",
    "serial_gate_score", "serial_gate_score_batch",
    "serial_gate_terms_batch",
    "Exploration", "GridExploration", "explore", "explore_grid",
    "prune_report",
]
