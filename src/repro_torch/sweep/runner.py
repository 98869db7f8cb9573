"""Sharded design-space sweeps: the scenario axis over hosts (port of
``repro.sweep.runner``).

The grid is embarrassingly parallel over scenarios, so a sweep is: cut
the scenario axis with a deterministic :class:`~repro_torch.sweep.plan.ShardPlan`,
evaluate each shard through any registered engine
(:mod:`repro_torch.core.engine`, ``"torch"`` on the card included), and
either **gather** the shards back into one bit-identical
:class:`~repro_torch.core.engine.GridResult` or **reduce** each shard to
a compact :class:`ShardSummary` the moment it finishes (1e7-point sweeps
never hold the full ``(L, S, M)`` table in memory).

Shards are owned round-robin by ``host_index`` out of ``host_count``
identical processes; every host derives the same plan and evaluates only
its shards (operands regenerate locally, e.g. ``repro_torch.sweep.synth``),
streaming summaries for an aggregator.  The third level,
``device_parallel=True``, splits each owned shard over the visible
cards.

Uniform and ragged batches shard identically — a ``RaggedBatch``'s
padded fraction matrix is row-sliced with the scenario axis, so
profiles travel with their scenarios.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.batch import RaggedBatch, ScenarioBatch
from repro_torch.core.engine import (
    GRID_SCHEDULES,
    Engine,
    GridResult,
    get_engine,
    is_ragged,
)
from repro_torch.core.schedule_types import Schedule
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.sweep.plan import ShardPlan, plan_shards, shards_for_host


# ---------------------------------------------------------------------------
# Batch / grid slicing and concatenation (scenario axis).
# ---------------------------------------------------------------------------


def _coerce_batch(scenarios) -> ScenarioBatch:
    from repro_torch.core import batch as _batch
    from repro_torch.core.engine import as_scenario_sequence

    scenarios = as_scenario_sequence(scenarios)
    if is_ragged(scenarios):
        return _batch._as_ragged_batch(scenarios)
    return _batch._as_batch(scenarios)


def _slice_batch(sb: ScenarioBatch, start: int, stop: int) -> ScenarioBatch:
    names = sb.names[start:stop] if sb.names else ()
    if isinstance(sb, RaggedBatch):
        return RaggedBatch(
            m=sb.m[start:stop], n=sb.n[start:stop], k=sb.k[start:stop],
            dtype_bytes=sb.dtype_bytes[start:stop], names=names,
            frac=sb.frac[start:stop],
        )
    return ScenarioBatch(
        m=sb.m[start:stop], n=sb.n[start:stop], k=sb.k[start:stop],
        dtype_bytes=sb.dtype_bytes[start:stop], names=names,
    )


def shard_batch(scenarios, plan: ShardPlan) -> list[ScenarioBatch]:
    """Slice a (possibly ragged) batch into the plan's shards."""
    sb = _coerce_batch(scenarios)
    return [_slice_batch(sb, start, stop) for start, stop in plan.bounds]


def concat_batches(parts) -> ScenarioBatch:
    """Concatenate scenario batches; ragged frac matrices pad to max P."""
    parts = list(parts)
    if not parts:
        raise ValueError("nothing to concatenate")
    if len(parts) == 1:
        return parts[0]
    names = ()
    if all(len(p.names) == len(p) for p in parts):
        names = tuple(nm for p in parts for nm in p.names)
    m = np.concatenate([p.m for p in parts])
    n = np.concatenate([p.n for p in parts])
    k = np.concatenate([p.k for p in parts])
    b = np.concatenate([p.dtype_bytes for p in parts])
    if any(isinstance(p, RaggedBatch) for p in parts):
        if not all(isinstance(p, RaggedBatch) for p in parts):
            raise TypeError("cannot mix ragged and uniform batches")
        p_max = max(p.frac.shape[1] for p in parts)
        frac = np.concatenate([
            np.pad(p.frac, ((0, 0), (0, p_max - p.frac.shape[1])))
            for p in parts
        ])
        return RaggedBatch(
            m=m, n=n, k=k, dtype_bytes=b, names=names, frac=frac
        )
    return ScenarioBatch(m=m, n=n, k=k, dtype_bytes=b, names=names)


def _slice_grid(g: GridResult, start: int, stop: int) -> GridResult:
    return GridResult(
        schedules=g.schedules,
        scenarios=_slice_batch(g.scenarios, start, stop),
        machines=g.machines,
        total=g.total[:, start:stop],
        comm_busy=g.comm_busy[:, start:stop],
        compute_busy=g.compute_busy[:, start:stop],
        exposed=g.exposed[:, start:stop],
        steps=g.steps,
        serial_comm=g.serial_comm[start:stop],
        serial_gemm=g.serial_gemm[start:stop],
        valid=g.valid[:, start:stop],
        dma=g.dma,
    )


def concat_grid_results(parts) -> GridResult:
    """Reassemble scenario-axis shards into one GridResult.

    The inverse of :func:`shard_batch` + per-shard evaluation: because
    every engine is elementwise over the scenario axis, the result is
    bit-identical to evaluating the concatenated batch directly.
    """
    parts = list(parts)
    if not parts:
        raise ValueError("nothing to concatenate")
    head = parts[0]
    for p in parts[1:]:
        if p.schedules != head.schedules or p.machines != head.machines:
            raise ValueError("shards disagree on schedules/machines")
        if p.dma != head.dma or not np.array_equal(p.steps, head.steps):
            raise ValueError("shards disagree on dma/step counts")
    if len(parts) == 1:
        return head
    return GridResult(
        schedules=head.schedules,
        scenarios=concat_batches([p.scenarios for p in parts]),
        machines=head.machines,
        total=np.concatenate([p.total for p in parts], axis=1),
        comm_busy=np.concatenate([p.comm_busy for p in parts], axis=1),
        compute_busy=np.concatenate(
            [p.compute_busy for p in parts], axis=1
        ),
        exposed=np.concatenate([p.exposed for p in parts], axis=1),
        steps=head.steps,
        serial_comm=np.concatenate([p.serial_comm for p in parts], axis=0),
        serial_gemm=np.concatenate([p.serial_gemm for p in parts], axis=0),
        valid=np.concatenate([p.valid for p in parts], axis=1),
        dma=head.dma,
    )


# ---------------------------------------------------------------------------
# Per-shard summaries (the "reduce" result mode).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardSummary:
    """Compact per-shard statistics — what multi-host sweeps stream."""

    shard: int
    start: int
    stop: int
    n_scenarios: int
    n_points: int  # scenarios x machines
    seconds: float
    scenarios_per_sec: float
    best_counts: dict[str, int]  # schedule value -> optimal-pick count
    frac_overlap_profitable: float
    mean_best_speedup: float

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def summarize_shard(
    grid: GridResult, shard: int, start: int, stop: int, seconds: float
) -> ShardSummary:
    """Reduce one shard's GridResult to a ShardSummary."""
    S, M = grid.total.shape[1], grid.total.shape[2]
    points = S * M
    if points == 0:
        return ShardSummary(
            shard, start, stop, S, 0, seconds, 0.0, {}, 0.0, 0.0
        )
    best = grid.best_idx()
    with np.errstate(divide="ignore", invalid="ignore"):
        speedup = grid.serial_total / grid.best_total()
    counts = {
        sched.value: int((best == l).sum())
        for l, sched in enumerate(grid.schedules)
    }
    if Schedule.SERIAL in grid.schedules:
        profitable = best != grid.schedule_idx(Schedule.SERIAL)
    else:
        profitable = np.ones_like(best, dtype=bool)
    finite = np.isfinite(speedup)
    return ShardSummary(
        shard=shard,
        start=start,
        stop=stop,
        n_scenarios=S,
        n_points=points,
        seconds=seconds,
        scenarios_per_sec=S / seconds if seconds > 0 else 0.0,
        best_counts=counts,
        frac_overlap_profitable=float(np.mean(profitable)),
        mean_best_speedup=float(np.mean(speedup[finite]))
        if finite.any()
        else 0.0,
    )


def merge_summaries(summaries) -> dict:
    """Aggregate shard summaries (from any subset of hosts) into totals."""
    summaries = list(summaries)
    counts: dict[str, int] = {}
    for s in summaries:
        for k, v in s.best_counts.items():
            counts[k] = counts.get(k, 0) + v
    scen = sum(s.n_scenarios for s in summaries)
    pts = sum(s.n_points for s in summaries)
    secs = sum(s.seconds for s in summaries)
    wmean = (
        sum(s.mean_best_speedup * s.n_points for s in summaries) / pts
        if pts
        else 0.0
    )
    wprof = (
        sum(s.frac_overlap_profitable * s.n_points for s in summaries) / pts
        if pts
        else 0.0
    )
    return {
        "n_shards": len(summaries),
        "n_scenarios": scen,
        "n_points": pts,
        "seconds": secs,
        "scenarios_per_sec": scen / secs if secs > 0 else 0.0,
        "best_counts": counts,
        "frac_overlap_profitable": wprof,
        "mean_best_speedup": wmean,
    }


# ---------------------------------------------------------------------------
# Device-parallel evaluation (contiguous pieces over the cards).
# ---------------------------------------------------------------------------


def _device_sharded_grid(
    sb: ScenarioBatch,
    machines,
    *,
    dma: bool,
    dma_into_place: bool,
    schedules,
    devices,
) -> GridResult:
    """One batch over ``devices``: contiguous pieces, one per device.

    Each piece runs the ``"torch"`` engine's tensor math on its device
    (all of them queued before any is read back, so the cards run
    together) and the pieces concatenate along the scenario axis in
    order.  The math is elementwise over scenarios, so the grid is
    bit-identical to the unsharded ``"torch"`` evaluation; unlike the
    reference's ``pmap`` nothing needs equal pieces, so nothing is
    padded.
    """
    from repro_torch.autotune import torchgrid

    machines = tuple(machines)
    schedules = tuple(schedules)
    S = len(sb)
    if S == 0:
        raise ValueError("cannot device-shard an empty batch")
    ragged = isinstance(sb, RaggedBatch)
    g_max = max(m.group for m in machines)
    waits = []
    for (start, stop), dev in zip(plan_shards(S, len(devices)).bounds,
                                  devices):
        if start == stop:
            continue
        mp = torchgrid.machine_arrays(machines, device=dev)
        piece = _slice_batch(sb, start, stop)
        evaluate = (torchgrid.evaluate_ragged_grid_raw if ragged
                    else torchgrid.evaluate_grid_raw)
        waits.append(torchgrid.to_host_async(evaluate(
            piece, mp, dma=dma, dma_into_place=dma_into_place,
            schedules=schedules, g_max=g_max,
        )))
    parts = [wait() for wait in waits]
    # Machine-major raw fields: (M, L, S) x 4, steps (M, L), valid
    # (M, L, S), serial comm and GEMM (M, S).
    raw = tuple(
        parts[0][i] if i == 4
        else np.concatenate([p[i] for p in parts], axis=-1)
        for i in range(8)
    )
    return GridResult.from_machine_major(
        raw, schedules=schedules, scenarios=sb, machines=machines, dma=dma
    )


# ---------------------------------------------------------------------------
# The sweep driver.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """What one host's sweep produced.

    ``grid`` is the reassembled GridResult over this host's owned shards
    (``mode="gather"``; None in reduce mode).  With ``host_count == 1``
    the owned shards are all shards, so ``grid`` is bit-identical to the
    unsharded engine evaluation.
    """

    plan: ShardPlan
    mode: str
    host_index: int
    host_count: int
    owned: tuple[int, ...]
    summaries: tuple[ShardSummary, ...]
    grid: GridResult | None

    def summary(self) -> dict:
        return merge_summaries(self.summaries)


def sweep_grid(
    scenarios,
    machines,
    *,
    backend: str = "numpy",
    engine: Engine | None = None,
    num_shards: int | None = None,
    mode: str = "gather",
    dma: bool = True,
    dma_into_place: bool = False,
    schedules=None,
    host_index: int = 0,
    host_count: int = 1,
    device_parallel: bool = False,
    devices=None,
    on_shard=None,
    on_shard_grid=None,
    overlap_dispatch: bool = False,
) -> SweepResult:
    """Sharded design-space sweep over the scenario axis.

    ``scenarios`` is anything the engines accept (uniform or ragged —
    ragged fraction matrices shard with their scenarios).  The plan cuts
    the axis into ``num_shards`` contiguous shards (default: one per
    host), owned round-robin by ``host_index`` of ``host_count``
    identical processes; only owned shards are evaluated.

    ``mode="gather"`` reassembles the owned shards into one
    :class:`GridResult` (bit-identical to the unsharded evaluation when
    a single host owns everything); ``mode="reduce"`` keeps only
    :class:`ShardSummary` per shard — the memory-bounded form for
    1e6-1e7-point sweeps.  ``on_shard`` (if given) is called with each
    summary as soon as its shard finishes — the streaming hook
    ``python -m repro_torch.scripts.sweep`` uses to emit JSON lines.

    ``on_shard_grid`` (if given) is called with ``(grid, summary)``
    while the shard's GridResult is still alive — i.e. *before* reduce
    mode drops it.  This is the sufficient-statistics hook: consumers
    like ``repro_torch.learn.stats.sweep_stats`` fold each shard into compact
    mergeable accumulators, so 1e6–1e7-point training sweeps stay
    memory-bounded without gathering a grid.  Empty shards skip both
    hooks' grid work (the summary hook still fires).

    ``device_parallel=True`` splits each owned shard into contiguous
    pieces over ``devices`` (torch devices; default every visible CUDA
    device) and evaluates each piece with the ``"torch"`` engine's math
    on its device, bit-identical to the unsharded ``"torch"`` grid;
    otherwise shards run through the engine named by ``backend`` /
    passed as ``engine``.

    ``overlap_dispatch=True`` double-buffers shards on engines exposing
    a two-phase ``dispatch()`` (the ``"mixed"`` engine): shard ``k+1``
    is queued on the card before shard ``k`` finalizes, the same
    overlap discipline ``ficco_ag_matmul`` applies to DMA egress.
    Per-shard ``seconds`` then overlap wall-clock.  Engines without
    ``dispatch`` fall back to eager evaluation — results are identical
    either way (summary order and all hook orderings are preserved),
    and the flag defaults off so every pre-existing path keeps its
    bit-identity contract trivially.  Ignored under ``device_parallel``.
    """
    if mode not in ("gather", "reduce"):
        raise ValueError(f"mode must be 'gather'|'reduce', got {mode!r}")
    if not 0 <= host_index < host_count:
        raise ValueError(
            f"host_index {host_index} outside [0, {host_count})"
        )
    sb = _coerce_batch(scenarios)
    machines = tuple(machines)
    schedules = (
        GRID_SCHEDULES if schedules is None else tuple(schedules)
    )
    dispatch_shard = None
    if device_parallel:
        if devices is None:
            from repro_torch.device import resolve_device

            resolve_device(None)  # raises without a card
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        eval_shard = lambda piece: _device_sharded_grid(  # noqa: E731
            piece, machines, dma=dma, dma_into_place=dma_into_place,
            schedules=schedules, devices=devices,
        )
    else:
        eng = engine if engine is not None else get_engine(backend)
        eval_shard = lambda piece: eng.evaluate(  # noqa: E731
            piece, machines, dma=dma, dma_into_place=dma_into_place,
            schedules=schedules,
        )
        dispatch_shard = getattr(eng, "dispatch", None)
    two_phase = overlap_dispatch and dispatch_shard is not None

    plan = plan_shards(
        len(sb), num_shards if num_shards is not None else host_count
    )
    owned = shards_for_host(plan, host_index, host_count)
    summaries: list[ShardSummary] = []
    parts: list[GridResult] = []

    reg = _metrics.get_metrics()

    def _complete(entry):
        shard, start, stop, t0, finalize = entry
        # Under two-phase dispatch this span is where the queued work is
        # waited for: in a trace, shard k+1's sweep/dispatch span opens
        # before shard k's sweep/compute closes.
        with _trace.span("sweep/compute", "sweep", shard=shard):
            grid = finalize()
        dt = time.perf_counter() - t0
        summ = summarize_shard(grid, shard, start, stop, dt)
        reg.counter("sweep/shards").inc()
        reg.counter("sweep/scenarios").inc(summ.n_scenarios)
        reg.histogram("sweep/shard_seconds").observe(dt)
        with _trace.span(
            "sweep/reduce", "sweep", shard=shard,
            n_scenarios=summ.n_scenarios, seconds=dt,
        ):
            if on_shard_grid is not None:
                on_shard_grid(grid, summ)
            if mode == "gather":
                parts.append(grid)
            summaries.append(summ)
            if on_shard is not None:
                on_shard(summ)

    pending = None
    with _trace.span(
        "sweep/run", "sweep", mode=mode, n_owned=len(owned),
        n_scenarios=len(sb), two_phase=two_phase,
        host_index=host_index, host_count=host_count,
    ):
        for shard in owned:
            start, stop = plan.bounds[shard]
            if start == stop:  # degenerate empty shard (more shards than S)
                if pending is not None:  # keep summaries in shard order
                    _complete(pending)
                    pending = None
                summ = ShardSummary(
                    shard, start, stop, 0, 0, 0.0, 0.0, {}, 0.0, 0.0
                )
                summaries.append(summ)
                if on_shard is not None:
                    on_shard(summ)
                continue
            piece = _slice_batch(sb, start, stop)
            t0 = time.perf_counter()
            with _trace.span(
                "sweep/dispatch", "sweep", shard=shard,
                start=start, stop=stop, two_phase=two_phase,
            ):
                if two_phase:
                    finalize = dispatch_shard(
                        piece, machines, dma=dma,
                        dma_into_place=dma_into_place,
                        schedules=schedules,
                    )
                else:
                    grid_now = eval_shard(piece)
                    finalize = lambda g=grid_now: g  # noqa: E731
            entry = (shard, start, stop, t0, finalize)
            if pending is not None:
                _complete(pending)
                pending = None
            if two_phase:
                pending = entry  # shard k+1 is queued before k finalizes
            else:
                _complete(entry)
        if pending is not None:
            _complete(pending)
    grid = None
    if mode == "gather":
        if parts:
            grid = concat_grid_results(parts)
        else:
            # Every owned shard was empty (or the batch itself is):
            # honor the gather contract with a 0-scenario GridResult
            # rather than None.  The NumPy engine handles S == 0 and
            # any engine agrees on an empty lane set.
            grid = get_engine("numpy").evaluate(
                _slice_batch(sb, 0, 0), machines,
                dma=dma, dma_into_place=dma_into_place,
                schedules=schedules,
            )
    return SweepResult(
        plan=plan,
        mode=mode,
        host_index=host_index,
        host_count=host_count,
        owned=owned,
        summaries=tuple(summaries),
        grid=grid,
    )


__all__ = [
    "ShardSummary",
    "SweepResult",
    "concat_batches",
    "concat_grid_results",
    "merge_summaries",
    "shard_batch",
    "summarize_shard",
    "sweep_grid",
]
