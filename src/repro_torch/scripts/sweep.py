"""Sharded design-space sweep driver: 1e6-1e8-point grids, streamed
(port of the reference's ``scripts/sweep.py``).

Evaluates a synthetic scenario grid through the sharded sweep subsystem
(``repro_torch.sweep``), streaming one JSON line per finished shard to
``--out`` and a merged summary at the end — so a large sweep never holds
the full result table and an aggregator can tail the shard stream live.

Single host, reduce mode (memory-bounded), 64 shards on the card::

    PYTHONPATH=src python -m repro_torch.scripts.sweep \\
        --scenarios 1000000 --shards 64 --mode reduce --out sweep.jsonl

Multi-host: run the same command on every host with its own
``--host-index`` (the deterministic plan + round-robin owner mapping
make the shard sets disjoint and exhaustive; operands regenerate from
the seed, nothing is broadcast)::

    PYTHONPATH=src python -m repro_torch.scripts.sweep \\
        --scenarios 10000000 --shards 256 --mode reduce \\
        --host-index $I --host-count 8 --out sweep_host$I.jsonl

``--backend mixed --dtype float32`` evaluates at reduced precision,
``--synth-device`` draws the scenarios on the card with the
counter-based generator, ``--overlap-dispatch`` double-buffers the
mixed engine's shards, and ``--device-parallel`` splits each owned shard
over the visible CUDA devices (bit-identical to the ``"torch"`` engine).
``--ragged`` sweeps skewed Dirichlet step profiles instead of uniform
splits.  Everything runs on the card unless ``--device cpu`` is given;
the default backend is ``"torch"`` (the reference's is ``"numpy"``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.core import engine_names
from repro_torch.core.workload import machine_grid
from repro_torch.device import resolve_device
from repro_torch.sweep import (
    merge_summaries,
    sweep_grid,
    synthetic_batch,
    synthetic_ragged_batch,
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scripts.sweep",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "--scenarios", type=int, default=100_000,
        help="synthetic scenario count (points = scenarios x machines)",
    )
    ap.add_argument(
        "--ragged", action="store_true",
        help="sweep skewed ragged step profiles instead of uniform splits",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--groups", type=int, nargs="+", default=[8],
        help="overlap-group sizes for the machine grid axis",
    )
    ap.add_argument(
        "--backend", choices=engine_names(), default="torch",
        help="engine for non-device-parallel shards",
    )
    ap.add_argument(
        "--dtype", choices=("float64", "float32", "bfloat16"),
        default="float64",
        help="evaluation dtype (non-float64 requires --backend mixed; "
        "the pipeline accumulator stays float64 either way)",
    )
    ap.add_argument(
        "--synth-device", action="store_true",
        help="synthesize scenarios with the counter-based generator on "
        "the device (repro_torch.sweep.device) instead of the host "
        "np.random stream — a different, shard-composable stream",
    )
    ap.add_argument(
        "--overlap-dispatch", action="store_true",
        help="double-buffer shard dispatch on two-phase engines "
        "(the mixed engine); no-op elsewhere",
    )
    ap.add_argument("--shards", type=int, default=None,
                    help="shard count (default: one per host)")
    ap.add_argument("--mode", choices=("gather", "reduce"),
                    default="reduce")
    ap.add_argument("--host-index", type=int, default=0)
    ap.add_argument("--host-count", type=int, default=1)
    ap.add_argument(
        "--device-parallel", action="store_true",
        help="split each owned shard over the visible CUDA devices "
        "(over --device alone with --device cpu)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device of the engine and the synthesis (default: the "
        "card; cpu runs the same tensor math on the host)",
    )
    ap.add_argument(
        "--use-fit", default=None, metavar="NAME",
        help="evaluate through the fitted engine: load the persisted "
        "sim-to-real fit artifact NAME (repro_torch.learn.fit) and patch "
        "its calibrated parameters into the matching machine lanes",
    )
    ap.add_argument(
        "--train-gate", default=None, metavar="NAME",
        help="reduce mode only: fold every shard grid into GateStats, "
        "train a LearnedGate and persist it under artifact NAME — with "
        "--use-fit this is the fit-then-retrain loop (the gate trains "
        "against the calibrated machine model)",
    )
    ap.add_argument(
        "--out", default=None, metavar="PATH",
        help="append one JSON line per finished shard (stdout if unset)",
    )
    ap.add_argument(
        "--trace", default=None, metavar="PATH",
        help="export a Chrome/Perfetto trace of the shard pipeline here",
    )
    ap.add_argument(
        "--metrics", default=None, metavar="PATH",
        help="append one metrics-snapshot JSON line here when done",
    )
    return ap


def main(argv=None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)

    engine = None
    if args.backend == "mixed":
        from repro_torch.core.engine import MixedEngine

        engine = MixedEngine(dtype=args.dtype, device=args.device)
    elif args.dtype != "float64":
        ap.error("--dtype other than float64 requires --backend mixed")
    if args.use_fit and engine is not None:
        ap.error("--use-fit is incompatible with --backend mixed")
    if args.train_gate and args.mode != "reduce":
        ap.error("--train-gate requires --mode reduce")
    device = resolve_device(args.device)

    if args.trace:
        from repro_torch.obs import trace as obs_trace

        obs_trace.enable(args.trace)

    if args.use_fit:
        from repro_torch.learn import FittedEngine, load_fit

        fit = load_fit(args.use_fit)
        if fit is None:
            ap.error(f"no persisted fit artifact {args.use_fit!r}")
        engine = FittedEngine(fit, device=device)
        print(
            f"# fitted engine: {fit.machine} params "
            f"{sorted(fit.fitted)} (loss {fit.loss0:.4g} -> "
            f"{fit.loss:.4g})",
            file=sys.stderr,
        )
    elif args.backend == "torch":
        from repro_torch.core.engine import TorchEngine

        engine = TorchEngine(device)

    gate_stats = None
    on_shard_grid = None
    if args.train_gate:
        from repro_torch.learn import GateStats

        gate_stats = GateStats.empty()

        def on_shard_grid(grid, _summ) -> None:
            gate_stats.update_from_grid(grid)

    if args.synth_device:
        from repro_torch.sweep import device_batch, device_ragged_batch

        make = device_ragged_batch if args.ragged else device_batch
        sb = make(args.scenarios, seed=args.seed, device=device)
    else:
        make = synthetic_ragged_batch if args.ragged else synthetic_batch
        sb = make(args.scenarios, seed=args.seed)
    machines = machine_grid(groups=tuple(args.groups))
    points = args.scenarios * len(machines)
    print(
        f"# sweep: {args.scenarios} scenarios x {len(machines)} machines "
        f"= {points} points ({'ragged' if args.ragged else 'uniform'}), "
        f"host {args.host_index}/{args.host_count}, {args.backend} "
        f"{args.dtype} on {device}",
        file=sys.stderr,
    )

    stream = open(args.out, "a") if args.out else sys.stdout

    def emit(summary) -> None:
        stream.write(json.dumps({"shard_summary": summary.to_json()}) + "\n")
        stream.flush()
        print(
            f"# shard {summary.shard}: {summary.n_scenarios} scenarios in "
            f"{summary.seconds:.2f}s ({summary.scenarios_per_sec:.0f}/s)",
            file=sys.stderr,
        )

    try:
        t0 = time.perf_counter()
        res = sweep_grid(
            sb,
            machines,
            backend=args.backend,
            engine=engine,
            num_shards=args.shards,
            mode=args.mode,
            host_index=args.host_index,
            host_count=args.host_count,
            device_parallel=args.device_parallel,
            devices=[device] if device.type == "cpu" else None,
            on_shard=emit,
            on_shard_grid=on_shard_grid,
            overlap_dispatch=args.overlap_dispatch,
        )
        wall = time.perf_counter() - t0
        merged = merge_summaries(res.summaries)
        merged["wall_seconds"] = wall
        merged["host_index"] = args.host_index
        merged["host_count"] = args.host_count
        merged["owned_shards"] = list(res.owned)
        # Per-shard duration distribution: the straggler signal a
        # dispatcher reads before re-sharding (p95 >> p50 = skewed).
        durations = sorted(
            s.seconds for s in res.summaries if s.n_scenarios > 0
        )
        if durations:
            from repro_torch.obs.metrics import Histogram

            h = Histogram()
            for d in durations:
                h.observe(d)
            merged["shard_seconds_total"] = sum(durations)
            merged["shard_seconds_p50"] = h.percentile(0.5)
            merged["shard_seconds_p95"] = h.percentile(0.95)
        # Recorded so the aggregator can refuse to merge mixed-precision
        # streams with float64 ones (the no-silent-mixing rule GateStats
        # enforces for bin edges).
        merged["dtype"] = args.dtype
        merged["synth"] = "device" if args.synth_device else "host"
        merged["device"] = str(device)
        if args.train_gate:
            from repro_torch.learn import save_gate, train_gate_from_stats

            gate = train_gate_from_stats(
                gate_stats,
                meta={
                    "source": "repro_torch.scripts.sweep",
                    "engine": (
                        f"fitted:{args.use_fit}" if args.use_fit
                        else args.backend
                    ),
                },
            )
            save_gate(gate, name=args.train_gate)
            merged["gate"] = {
                "name": args.train_gate,
                "n_leaves": gate.n_leaves,
                "trained_regret_q": gate.meta.get("trained_regret_q"),
            }
            print(
                f"# trained gate {args.train_gate!r}: {gate.n_leaves} "
                f"leaves over {gate_stats.n_points} points",
                file=sys.stderr,
            )
        # Total shard count of the deterministic plan: what the
        # gather-side aggregator checks completeness against.
        merged["plan_shards"] = len(res.plan.bounds)
        stream.write(json.dumps({"host_summary": merged}) + "\n")
        stream.flush()
    finally:
        if args.out:
            stream.close()
    if args.metrics:
        from repro_torch.obs import metrics as obs_metrics

        # Reservoir + host identity make the export fleet-mergeable.
        obs_metrics.get_metrics().export_jsonl(
            args.metrics, reservoir=True,
            host={"host_index": args.host_index},
        )
    if args.trace:
        from repro_torch.obs import trace as obs_trace

        obs_trace.disable()  # exports to args.trace
    print(
        f"# done: {merged['n_scenarios']} scenarios "
        f"({merged['n_points']} points) in {wall:.2f}s wall "
        f"-> {merged['n_scenarios'] / wall:.0f} scenarios/s",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
