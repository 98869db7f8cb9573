"""Measured engine: shortlist-only evaluation backed by real timings (port
of ``repro.learn.measured``).

The engine-registry extension path: a backend that lives entirely outside ``repro_torch.core`` and
registers itself through the public ``register_engine`` API
(``repro_torch.learn`` registers it as ``"measured"``).

Semantics — *shortlist-only* evaluation:

  * an analytic engine (``analytic_backend``, default ``"numpy"``)
    ranks every schedule for each (scenario, machine) point;
  * only the top-``top`` analytic candidates (plus SERIAL, the
    always-executable reference) survive — everything else is
    invalidated in the returned grid, exactly as measuring only a
    shortlist leaves the rest unknown;
  * surviving entries are **overridden with measured wall times** where
    the autotune decision cache holds a measured-tier record for the
    point's :class:`~repro_torch.autotune.tuner.TuneKey` (what
    ``Autotuner.measure`` persists); points never measured keep the
    analytic model time.

So ``grid.best_idx()`` over a measured-engine grid prefers empirical
winners wherever the measured tier has visited, and falls back to the
model elsewhere — the grid-shaped view of the autotuner's tier-3 data,
usable by every grid consumer (``GridExploration``, the calibrators,
``repro_torch.learn`` training).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.schedule_types import Schedule


class MeasuredEngine:
    """Shortlist-only engine over the measured-tier record store.

    Capability flags: host-side NumPy post-processing of another
    engine's grid — not jitted, not differentiable (measured wall times
    have no gradients), but trace-safe (it launches no device work of
    its own).
    Ragged profiles are supported: the analytic base grid comes from the
    ragged evaluator and the measured lookup keys on the per-scenario
    profile digest — exactly the profile-keyed records the skewed
    ``ficco_a2a_ffn`` variant search persists.
    """

    name = "measured"
    supports_ragged = True
    jit = False
    differentiable = False
    trace_safe = True

    def __init__(
        self,
        cache=None,
        *,
        analytic_backend: str = "numpy",
        top: int = 3,
    ):
        self._cache = cache
        self.analytic_backend = analytic_backend
        self.top = top

    def _store(self):
        if self._cache is not None:
            return self._cache
        from repro_torch.autotune.tuner import get_tuner

        return get_tuner().cache

    def evaluate(
        self,
        scenarios,
        machines,
        *,
        dma: bool = True,
        dma_into_place: bool = False,
        schedules: tuple[Schedule, ...] | None = None,
    ):
        import dataclasses

        from repro_torch.core.engine import (
            as_scenario_sequence,
            get_engine,
            is_ragged,
        )
        from repro_torch.autotune.tuner import TuneKey

        scenarios = as_scenario_sequence(scenarios)
        ragged = is_ragged(scenarios)
        # Profile digests key the measured lookup for ragged scenarios.
        # Prefer the original RaggedScenario profiles (their name enters
        # the digest); a bare RaggedBatch reconstructs name-less
        # "custom" profiles, which only match records stored the same way.
        profiles = None
        if ragged:
            if isinstance(scenarios, (list, tuple)):
                profiles = [s.profile for s in scenarios]
        base = get_engine(self.analytic_backend).evaluate(
            scenarios, machines,
            dma=dma, dma_into_place=dma_into_place, schedules=schedules,
        )
        if ragged and profiles is None:
            profiles = [
                base.scenarios.profile(i) for i in range(len(base.scenarios))
            ]
        cache = self._store()
        total = base.total.copy()
        comm = base.comm_busy.copy()
        compute = base.compute_busy.copy()
        exposed = base.exposed.copy()
        valid = base.valid.copy()
        serial_l = (
            base.schedules.index(Schedule.SERIAL)
            if Schedule.SERIAL in base.schedules
            else None
        )
        L, S, M = total.shape
        for j, machine in enumerate(base.machines):
            for i in range(S):
                col = np.where(valid[:, i, j], total[:, i, j], np.inf)
                order = np.argsort(col, kind="stable")
                keep = set(int(l) for l in order[: self.top] if np.isfinite(col[l]))
                if serial_l is not None:
                    keep.add(serial_l)
                entry = cache.get(
                    str(
                        TuneKey.for_gemm(
                            base.scenarios.gemm(i),
                            machine,
                            profile=profiles[i] if profiles else None,
                        )
                    )
                )
                t_meas = entry.get("measured_total_s") if entry else None
                for l in range(L):
                    if l not in keep:
                        total[l, i, j] = np.nan
                        comm[l, i, j] = np.nan
                        compute[l, i, j] = np.nan
                        exposed[l, i, j] = np.nan
                        valid[l, i, j] = False
                        continue
                    if t_meas and entry.get("schedule") == base.schedules[
                        l
                    ].value:
                        total[l, i, j] = float(t_meas)
        return dataclasses.replace(
            base,
            total=total,
            comm_busy=comm,
            compute_busy=compute,
            exposed=exposed,
            valid=valid,
        )


def register_measured_engine(*, overwrite: bool = False) -> None:
    """Register ``"measured"`` in the engine registry (idempotent)."""
    from repro_torch.core.engine import engine_names, register_engine

    if overwrite or "measured" not in engine_names():
        register_engine("measured", MeasuredEngine, overwrite=overwrite)


__all__ = ["MeasuredEngine", "register_measured_engine"]
