"""Unified engine facade: one backend protocol over the design-space grid
(port of ``repro.core.engine``).

Three numerically-pinned engines evaluate the same ``(schedule, scenario,
machine)`` design-space grid:

  * :class:`ScalarEngine`  — the discrete simulator
    (``repro_torch.core.simulator.simulate``) in Python loops; slow,
    obvious, the ground truth the batched engines are tested against.
  * :class:`NumpyEngine`   — the vectorized batched engine
    (``repro_torch.core.batch``) on the host; bit-identical to the scalar
    recurrence.
  * :class:`TorchEngine`   — float64 tensor math on the card
    (``repro_torch.autotune.torchgrid``, the reference's jitted ``"jax"``
    engine's role): within 1e-9 relative of NumPy, every machine in one
    batched evaluation, differentiable through TAU and the machine
    parameters by autograd.

All three speak the same :class:`Engine` protocol — ``evaluate(batch) ->
GridResult`` for **uniform and ragged** scenario batches — and register
themselves in a process-wide registry, so everything downstream
(``explore_grid``, the shortlist, the heuristic calibrators,
``repro_torch.sweep``) resolves a backend by name:

    from repro_torch.core.engine import get_engine
    grid = get_engine("torch").evaluate(scenarios, machines)

A fourth on the same protocol, :class:`MixedEngine` (``"mixed"``), runs
the torch engine's math with the machine leaves at float32 or bfloat16
for sweep throughput (``repro_torch.sweep.device``).  The reference's ``"jax"``
name is not registered: ``get_engine("jax")`` raises the unknown-backend
error, which lists the registered engines.

:class:`GridResult` — the one canonical dense result table — also lives
here; ``repro_torch.core.batch`` re-exports it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.machine import MachineSpec
from repro_torch.core.schedule_types import STUDIED, Schedule
from repro_torch.core.simulator import SimResult
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

# Canonical schedule order — matches the dict order of
# ``simulator.best_schedule`` so argmin tie-breaking is identical.
GRID_SCHEDULES: tuple[Schedule, ...] = (
    Schedule.SERIAL,
    Schedule.SHARD_P2P,
    *STUDIED,
)
SCHEDULE_INDEX = {s: i for i, s in enumerate(GRID_SCHEDULES)}

_FICCO_SCHEDULES = frozenset(STUDIED)


# ---------------------------------------------------------------------------
# The one canonical result table.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridResult:
    """Dense result table over (schedule, scenario, machine).

    ``total``/``comm_busy``/``compute_busy``/``exposed`` have shape
    ``(L, S, M)`` with L = ``len(schedules)``; ``serial_comm`` /
    ``serial_gemm`` are ``(S, M)``.  Entries where the scalar simulator
    would raise (indivisible decompositions) are NaN with ``valid`` False.

    Every engine returns exactly this shape (scenario-major layout); the
    torch engine assembles it from its machine-major stacks via
    :meth:`from_machine_major`.
    """

    schedules: tuple[Schedule, ...]
    scenarios: "ScenarioBatch"  # noqa: F821 — repro_torch.core.batch (no cycle)
    machines: tuple[MachineSpec, ...]
    total: np.ndarray
    comm_busy: np.ndarray
    compute_busy: np.ndarray
    exposed: np.ndarray
    steps: np.ndarray  # (L, M) int
    serial_comm: np.ndarray
    serial_gemm: np.ndarray
    valid: np.ndarray
    dma: bool

    @property
    def serial_total(self) -> np.ndarray:
        return self.serial_comm + self.serial_gemm

    @property
    def speedup(self) -> np.ndarray:
        """(L, S, M) speedup of each schedule vs the serial reference."""
        return self.serial_total[None, :, :] / self.total

    def best_idx(self) -> np.ndarray:
        """(S, M) index into ``schedules`` of the fastest valid schedule."""
        masked = np.where(self.valid, self.total, np.inf)
        return np.argmin(masked, axis=0)

    def best_total(self) -> np.ndarray:
        masked = np.where(self.valid, self.total, np.inf)
        return np.min(masked, axis=0)

    def schedule_idx(self, schedule: Schedule) -> int:
        return self.schedules.index(schedule)

    @classmethod
    def from_machine_major(
        cls,
        raw,
        *,
        schedules,
        scenarios,
        machines,
        dma: bool,
    ) -> "GridResult":
        """Assemble from the torch engine's machine-major stacks.

        ``raw`` is the 8-tuple ``(total, comm_busy, compute_busy,
        exposed, steps, valid, serial_comm, serial_gemm)`` with a
        leading machine axis — ``total`` is ``(M, L, S)``, ``steps`` is
        ``(M, L)``, ``serial_*`` are ``(M, S)`` — exactly what
        ``torchgrid.evaluate_grid_raw`` / ``evaluate_ragged_grid_raw``
        produce (as host arrays).  Transposed here, once, to the
        canonical scenario-major layout.
        """
        total, comm_busy, compute_busy, exposed, steps, valid, sc, sg = (
            np.asarray(a) for a in raw
        )
        return cls(
            schedules=tuple(schedules),
            scenarios=scenarios,
            machines=tuple(machines),
            total=np.transpose(total, (1, 2, 0)),
            comm_busy=np.transpose(comm_busy, (1, 2, 0)),
            compute_busy=np.transpose(compute_busy, (1, 2, 0)),
            exposed=np.transpose(exposed, (1, 2, 0)),
            steps=np.transpose(steps, (1, 0)),
            serial_comm=np.transpose(sc, (1, 0)),
            serial_gemm=np.transpose(sg, (1, 0)),
            valid=np.transpose(valid, (1, 2, 0)),
            dma=dma,
        )

    def sim_result(self, schedule: Schedule, i: int, j: int) -> SimResult:
        """Materialize one scalar :class:`SimResult` from the grid."""
        l = self.schedule_idx(schedule)
        if not self.valid[l, i, j]:
            raise ValueError(
                f"{schedule} invalid for scenario {i} on "
                f"{self.machines[j].name} (indivisible decomposition)"
            )
        return SimResult(
            schedule,
            float(self.total[l, i, j]),
            float(self.comm_busy[l, i, j]),
            float(self.compute_busy[l, i, j]),
            float(self.exposed[l, i, j]),
            int(self.steps[l, j]),
            float(self.serial_comm[i, j]),
            float(self.serial_gemm[i, j]),
        )


# ---------------------------------------------------------------------------
# The engine protocol.
# ---------------------------------------------------------------------------


def as_scenario_sequence(scenarios):
    """Materialize generic iterables so dispatch can inspect them.

    Batches and lists/tuples pass through; generators and other
    iterables are drained to a list (otherwise :func:`is_ragged` would
    silently classify an iterator of RaggedScenario as uniform and the
    profiles would be dropped).
    """
    from repro_torch.core.batch import ScenarioBatch

    if isinstance(scenarios, (ScenarioBatch, list, tuple)):
        return scenarios
    return list(scenarios)


def is_ragged(scenarios) -> bool:
    """True iff ``scenarios`` carries non-uniform step profiles.

    Pass generic iterables through :func:`as_scenario_sequence` first —
    this predicate does not consume iterators.
    """
    from repro_torch.core.batch import RaggedBatch
    from repro_torch.core.workload import RaggedScenario

    if isinstance(scenarios, RaggedBatch):
        return True
    if isinstance(scenarios, (list, tuple)) and len(scenarios) > 0:
        return isinstance(scenarios[0], RaggedScenario)
    return False


def _observe_evaluate(name: str, scenarios):
    """Span + counter for one engine evaluation (no-op when disabled)."""
    try:
        n = len(scenarios)
    except TypeError:  # raw generators: counted after coercion, skip here
        n = None
    _metrics.get_metrics().counter(f"engine/evaluate.{name}").inc()
    return _trace.span(
        "engine/evaluate", "engine", engine=name, n_scenarios=n
    )


@runtime_checkable
class Engine(Protocol):
    """One design-space evaluation backend.

    ``evaluate`` accepts every scenario form the engines accept today —
    ``ScenarioBatch`` / ``RaggedBatch`` / lists of ``Scenario`` /
    ``RaggedScenario`` / ``GemmShape`` — dispatching uniform vs ragged
    on the input type, and returns the canonical :class:`GridResult`.

    Capability flags:
      * ``supports_ragged`` — accepts non-uniform step profiles.
      * ``jit``            — compiled/on-accelerator evaluation.
      * ``differentiable`` — gradients flow through machine params/TAU.
      * ``trace_safe``     — callable while a graph is being traced (a
        non-safe engine would stage its own work into the caller's graph).
    """

    name: str
    supports_ragged: bool
    jit: bool
    differentiable: bool
    trace_safe: bool

    def evaluate(
        self,
        scenarios,
        machines,
        *,
        dma: bool = True,
        dma_into_place: bool = False,
        schedules: tuple[Schedule, ...] | None = None,
    ) -> GridResult: ...


class ScalarEngine:
    """Scalar engine: ``simulate()`` in Python loops.

    O(S x M x L) Python-level work — the ground truth for differential
    tests and tiny queries; :class:`NumpyEngine` is the one for sweeps.
    Matches :class:`NumpyEngine` bit for bit: same formulas, same
    accumulation order (the batched pipeline scan replicates the scalar
    recurrence exactly).
    """

    name = "scalar"
    supports_ragged = True
    jit = False
    differentiable = False
    trace_safe = True

    def evaluate(
        self,
        scenarios,
        machines,
        *,
        dma: bool = True,
        dma_into_place: bool = False,
        schedules: tuple[Schedule, ...] | None = None,
    ) -> GridResult:
        from repro_torch.core import batch as _batch
        from repro_torch.core.simulator import simulate

        schedules = (
            GRID_SCHEDULES if schedules is None else tuple(schedules)
        )
        scenarios = as_scenario_sequence(scenarios)
        ragged = is_ragged(scenarios)
        sb = (
            _batch._as_ragged_batch(scenarios)
            if ragged
            else _batch._as_batch(scenarios)
        )
        machines = tuple(machines)
        _span = _observe_evaluate(self.name, sb)
        _span.__enter__()
        L, S, M = len(schedules), len(sb), len(machines)
        total = np.full((L, S, M), np.nan)
        comm_busy = np.full((L, S, M), np.nan)
        compute_busy = np.full((L, S, M), np.nan)
        exposed = np.full((L, S, M), np.nan)
        steps = np.zeros((L, M), dtype=np.int64)
        serial_comm = np.zeros((S, M))
        serial_gemm = np.zeros((S, M))
        valid = np.zeros((L, S, M), dtype=bool)
        profiles = [sb.profile(i) for i in range(S)] if ragged else None
        for j, machine in enumerate(machines):
            # Step counts follow the engine convention (shared with the
            # batched engines): serial collapses to one step, everything
            # else pipelines over the group / padded profile length.
            for l, sched in enumerate(schedules):
                if sched is Schedule.SERIAL:
                    steps[l, j] = 1
                elif ragged and sched in _FICCO_SCHEDULES:
                    steps[l, j] = sb.max_steps
                else:
                    steps[l, j] = machine.group
            for i in range(S):
                gemm = sb.gemm(i)
                # Serial reference times are analytic metadata the
                # batched engines compute for every scenario whatever
                # the requested schedule subset — never raise.
                r0 = simulate(gemm, machine, Schedule.SERIAL, dma=dma)
                serial_comm[i, j] = r0.serial_comm
                serial_gemm[i, j] = r0.serial_gemm
                for l, sched in enumerate(schedules):
                    prof = (
                        profiles[i]
                        if ragged and sched in _FICCO_SCHEDULES
                        else None
                    )
                    try:
                        r = simulate(
                            gemm, machine, sched,
                            dma=dma, dma_into_place=dma_into_place,
                            profile=prof,
                        )
                    except ValueError:
                        continue  # indivisible decomposition: stays NaN
                    total[l, i, j] = r.total
                    comm_busy[l, i, j] = r.comm_busy
                    compute_busy[l, i, j] = r.compute_busy
                    exposed[l, i, j] = r.exposed_comm
                    valid[l, i, j] = True
        _span.__exit__(None, None, None)
        return GridResult(
            schedules=schedules,
            scenarios=sb,
            machines=machines,
            total=total,
            comm_busy=comm_busy,
            compute_busy=compute_busy,
            exposed=exposed,
            steps=steps,
            serial_comm=serial_comm,
            serial_gemm=serial_gemm,
            valid=valid,
            dma=dma,
        )


class NumpyEngine:
    """The vectorized batched engine (``repro_torch.core.batch``)."""

    name = "numpy"
    supports_ragged = True
    jit = False
    differentiable = False
    trace_safe = True

    def evaluate(
        self,
        scenarios,
        machines,
        *,
        dma: bool = True,
        dma_into_place: bool = False,
        schedules: tuple[Schedule, ...] | None = None,
    ) -> GridResult:
        from repro_torch.core import batch as _batch

        scenarios = as_scenario_sequence(scenarios)
        fn = (
            _batch.evaluate_ragged_grid
            if is_ragged(scenarios)
            else _batch.evaluate_grid
        )
        with _observe_evaluate(self.name, scenarios):
            return fn(
                scenarios, machines, dma=dma, dma_into_place=dma_into_place,
                schedules=GRID_SCHEDULES if schedules is None else schedules,
            )


class TorchEngine:
    """Float64 tensor math on the card (``repro_torch.autotune.torchgrid``).

    The reference's :class:`JaxEngine` role, without a compiler: the same
    formulas as the NumPy engine in the same accumulation order, every
    machine of the grid a leading tensor dimension, gradients by
    autograd.  ``device`` defaults to the card; a host without CUDA
    raises at ``evaluate`` unless the engine was built with
    ``device="cpu"``.  ``torchgrid`` is imported lazily, so resolving
    ``get_engine("torch")`` costs nothing until ``evaluate``.

    Capability flags: ``jit`` is False (eager PyTorch, no compilation,
    no CUDA graph) and so is ``trace_safe`` (it launches its own device
    work).
    """

    name = "torch"
    supports_ragged = True
    jit = False
    differentiable = True
    trace_safe = False

    def __init__(self, device=None):
        self.device = device

    def evaluate(
        self,
        scenarios,
        machines,
        *,
        dma: bool = True,
        dma_into_place: bool = False,
        schedules: tuple[Schedule, ...] | None = None,
    ) -> GridResult:
        from repro_torch.autotune import torchgrid

        scenarios = as_scenario_sequence(scenarios)
        fn = (
            torchgrid.evaluate_ragged_grid
            if is_ragged(scenarios)
            else torchgrid.evaluate_grid
        )
        with _observe_evaluate(self.name, scenarios):
            return fn(
                scenarios, machines, dma=dma, dma_into_place=dma_into_place,
                schedules=GRID_SCHEDULES if schedules is None else schedules,
                device=self.device,
            )


class MixedEngine:
    """Mixed-precision engine on the card (``repro_torch.sweep.device``).

    The :class:`TorchEngine`'s tensor math with the
    :class:`~repro_torch.autotune.torchgrid.MachineArrays` float leaves
    packed at ``dtype`` (float32 by default, bfloat16 on request), so the
    grid evaluates at reduced precision; float64 is confined to the
    pipeline's accumulator and the output container.  Built for sweep
    throughput (1e8-lane gate-training sweeps), not reference numerics:
    grids agree with the float64 engines only to the evaluation dtype's
    precision (``tests/test_torch_sweep_device.py`` pins the
    tolerances), and ``dtype="float64"`` is bit-identical to
    ``"torch"``.

    Capability flags: ``differentiable`` is False (gradients through
    bf16/f32 are calibration-grade noise; calibration keeps the
    ``"torch"`` engine); ``jit`` is False, as on :class:`TorchEngine`,
    since there is no compiler (the reference's flag is True); and
    ``trace_safe`` is False.  ``device`` defaults to the card.
    """

    name = "mixed"
    supports_ragged = True
    jit = False
    differentiable = False
    trace_safe = False

    def __init__(self, dtype: str = "float32", *, device=None):
        if dtype not in ("float64", "float32", "bfloat16"):
            raise ValueError(
                f"MixedEngine dtype must be float64|float32|bfloat16, "
                f"got {dtype!r}"
            )
        self.dtype = dtype
        self.device = device

    def evaluate(
        self,
        scenarios,
        machines,
        *,
        dma: bool = True,
        dma_into_place: bool = False,
        schedules: tuple[Schedule, ...] | None = None,
    ) -> GridResult:
        from repro_torch.sweep import device as _device

        with _observe_evaluate(self.name, scenarios):
            return _device.evaluate_mixed_grid(
                scenarios, machines, dtype=self.dtype,
                dma=dma, dma_into_place=dma_into_place,
                schedules=GRID_SCHEDULES if schedules is None else schedules,
                device=self.device,
            )

    def dispatch(
        self,
        scenarios,
        machines,
        *,
        dma: bool = True,
        dma_into_place: bool = False,
        schedules: tuple[Schedule, ...] | None = None,
    ):
        """Queue an evaluation on the card; returns ``finalize()``.

        Nothing synchronises before the returned zero-argument callable
        is called; it waits for this evaluation's copies back and
        assembles the :class:`GridResult`.  This is the two-phase form
        ``repro_torch.sweep.runner``'s double-buffered shard loop uses to
        keep shard k+1 running while shard k materialises.
        """
        from repro_torch.sweep import device as _device

        return _device.dispatch_mixed_grid(
            scenarios, machines, dtype=self.dtype,
            dma=dma, dma_into_place=dma_into_place,
            schedules=GRID_SCHEDULES if schedules is None else schedules,
            device=self.device,
        )


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], Engine]] = {}
_INSTANCES: dict[str, Engine] = {}


def register_engine(
    name: str,
    factory: Callable[[], Engine],
    *,
    overwrite: bool = False,
) -> None:
    """Register an engine factory under ``name``.

    Third parties (tests, experimental backends such as
    ``repro_torch.learn.measured``) can register their own.  A name collision
    raises — registering over an existing engine would silently reroute
    every ``backend=`` caller — unless ``overwrite=True`` is passed
    explicitly; the error lists the registered names, mirroring
    :func:`get_engine`'s unknown-name diagnostic.
    """
    if not overwrite and name in _REGISTRY:
        raise ValueError(
            f"engine {name!r} already registered (pass overwrite=True to "
            f"replace it); registered engines: {', '.join(engine_names())}"
        )
    _REGISTRY[name] = factory
    _INSTANCES.pop(name, None)


def engine_names() -> tuple[str, ...]:
    """Registered backend names, sorted."""
    return tuple(sorted(_REGISTRY))


def get_engine(backend) -> Engine:
    """Resolve a backend name (or pass through an Engine instance).

    Unknown names raise a ``ValueError`` that lists every registered
    engine, so a typo'd ``backend=`` never falls through silently.
    """
    if not isinstance(backend, str):
        if isinstance(backend, Engine):
            return backend
        raise TypeError(
            f"backend must be an engine name or Engine, got {backend!r}"
        )
    factory = _REGISTRY.get(backend)
    if factory is None:
        raise ValueError(
            f"unknown engine backend {backend!r}; registered engines: "
            f"{', '.join(engine_names())}"
        )
    inst = _INSTANCES.get(backend)
    if inst is None:
        inst = _INSTANCES[backend] = factory()
    return inst


register_engine("scalar", ScalarEngine)
register_engine("numpy", NumpyEngine)
register_engine("torch", TorchEngine)
register_engine("mixed", MixedEngine)


# ---------------------------------------------------------------------------
# Backend-generic shortlist (what a tuner ranks with).
# ---------------------------------------------------------------------------


def shortlist(
    gemm,
    machine: MachineSpec,
    *,
    top: int = 3,
    dma: bool = True,
    backend: str = "numpy",
    profile=None,
    engine: Engine | None = None,
) -> list[tuple[Schedule, float]]:
    """Top-``top`` valid schedules for one GEMM, fastest first.

    ``backend`` names any registered engine (``engine=`` passes an
    instance directly).  It defaults to ``"numpy"`` where the reference
    defaults to ``"jax"``: one GEMM's ranking is host work, and the
    NumPy engine is the oracle the ``"torch"`` engine is held to.
    Model times accompany each schedule so callers
    can decide whether measuring is worth it (close calls) or not.
    ``profile`` ranks the schedules under a ragged step profile instead
    of the uniform split (skew-aware tuning).
    """
    from repro_torch.core.batch import RaggedBatch, ScenarioBatch

    eng = engine if engine is not None else get_engine(backend)
    if profile is not None:
        batch = RaggedBatch.from_batch_and_profiles(
            ScenarioBatch.from_gemms([gemm]), [profile]
        )
    else:
        batch = ScenarioBatch.from_gemms([gemm])
    grid = eng.evaluate(batch, (machine,), dma=dma)
    total = np.where(grid.valid[:, 0, 0], grid.total[:, 0, 0], np.inf)
    order = np.argsort(total, kind="stable")
    out = []
    for l in order[:top]:
        if not np.isfinite(total[l]):
            break
        out.append((grid.schedules[int(l)], float(total[l])))
    return out


__all__ = [
    "GRID_SCHEDULES",
    "SCHEDULE_INDEX",
    "GridResult",
    "Engine",
    "ScalarEngine",
    "NumpyEngine",
    "TorchEngine",
    "MixedEngine",
    "register_engine",
    "engine_names",
    "get_engine",
    "as_scenario_sequence",
    "is_ragged",
    "shortlist",
]
