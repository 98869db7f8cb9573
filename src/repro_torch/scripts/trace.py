"""Observability command line: schedule timelines, trace/metric
validation, replay (port of the reference's ``scripts/trace.py``).

Five subcommands over the :mod:`repro_torch.obs` stack:

``timeline``
    Render named Table-I scenarios (or any ``--gemm M N K``) as per-step
    comm/GEMM/stall lane timelines — one Perfetto process per
    (scenario, schedule) pair — annotated with the paper's inefficiency
    decomposition.  Open the output in chrome://tracing or
    https://ui.perfetto.dev::

        PYTHONPATH=src python -m repro_torch.scripts.trace timeline \\
            --scenario g1 g4 --schedule all --out timeline.json

    ``--machine`` takes any machine of the port's ``MACHINES``
    (``h100-sxm-8`` among them); the default is the reference's,
    ``tpu-v5e-axis16``.

``validate``
    Schema-validate an exported trace file, metrics snapshot (JSONL),
    decision-audit log, signature-snapshot stream, sentinel-event
    stream, or merged fleet snapshot; exit non-zero on any violation
    (CI hook)::

        PYTHONPATH=src python -m repro_torch.scripts.trace validate \\
            trace.json
        PYTHONPATH=src python -m repro_torch.scripts.trace validate \\
            --kind metrics metrics.jsonl

``signature``
    Overlay streamed inefficiency-signature snapshots
    (``REPRO_SIGNATURES=sig.jsonl`` / ``--signatures``) on the schedule
    grid: per (machine family, scenario class) row, each observed
    schedule's decision count, mean analytic time, and dominant loss
    category::

        PYTHONPATH=src python -m repro_torch.scripts.trace signature \\
            sig.jsonl

``metrics``
    Summarize a metrics JSONL snapshot stream: counters, histogram
    percentiles, and tuner tier rates per snapshot line.

``audit``
    Print a decision-audit log (``decisions-torch.jsonl`` beside the
    port's autotune cache); ``--replay`` re-derives every pick offline on
    the host (the ``"numpy"`` engine by default) and reports whether the
    recorded schedule/tier choices reproduce::

        PYTHONPATH=src python -m repro_torch.scripts.trace audit --replay

Everything runs on the host; nothing here touches a device.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.machine import MACHINES, TPU_V5E, machine_for_group
from repro_torch.core.schedule_types import STUDIED, Schedule
from repro_torch.core.workload import SCENARIOS, GemmShape
from repro_torch.obs import audit as obs_audit
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import sentinel as obs_sentinel
from repro_torch.obs import signature as obs_signature
from repro_torch.obs import timeline as obs_timeline
from repro_torch.obs import trace as obs_trace


def _machine(name: str):
    if name in MACHINES:
        return MACHINES[name]
    known = ", ".join(sorted(MACHINES))
    raise SystemExit(f"unknown machine {name!r} (known: {known})")


def _schedules(arg: list[str]) -> list[Schedule]:
    if arg == ["all"]:
        return list(STUDIED)
    return [Schedule(a) for a in arg]


def cmd_timeline(args) -> int:
    machine = _machine(args.machine)
    if args.group:
        machine = machine_for_group(machine, args.group)
    targets = []
    for name in args.scenario:
        if name not in SCENARIOS:
            known = ", ".join(SCENARIOS)
            raise SystemExit(f"unknown scenario {name!r} (known: {known})")
        targets.append((name, SCENARIOS[name].gemm))
    if args.gemm:
        m, n, k = args.gemm
        targets.append((f"gemm {m}x{n}x{k}", GemmShape(m, n, k, 2)))
    if not targets:
        raise SystemExit("nothing to render: pass --scenario and/or --gemm")

    tr = obs_trace.Tracer()
    pid = 0
    rendered = skipped = 0
    for label, gemm in targets:
        for sched in _schedules(args.schedule):
            pid += 1
            try:
                _, sig = obs_timeline.schedule_timeline(
                    gemm, machine, sched,
                    dma=not args.no_dma, tracer=tr, pid=pid, name=label,
                )
            except ValueError as e:  # indivisible decomposition
                print(f"skip {label} / {sched.value}: {e}", file=sys.stderr)
                skipped += 1
                continue
            rendered += 1
            print(
                f"{label:>16}  {sched.value:<18} total {sig['total_s']:.6f}s"
                f"  speedup {sig['speedup']:.3f}"
                f"  exposure {sig['exposure_s']:.6f}s"
            )
    obj = tr.to_json()
    errors = obs_trace.validate_trace(obj)
    if errors:
        for e in errors:
            print(f"schema error: {e}", file=sys.stderr)
        return 1
    with open(args.out, "w") as f:
        json.dump(obj, f)
    print(
        f"wrote {args.out}: {rendered} timelines"
        f" ({len(obj['traceEvents'])} events, {skipped} skipped)"
    )
    return 0


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def cmd_validate(args) -> int:
    errors: list[str] = []
    if args.kind == "trace":
        with open(args.path) as f:
            errors = obs_trace.validate_trace(json.load(f))
    elif args.kind == "metrics":
        for i, snap in enumerate(_jsonl(args.path)):
            errors += [
                f"line {i}: {e}"
                for e in obs_metrics.validate_snapshot(snap)
            ]
    elif args.kind == "merged":
        with open(args.path) as f:
            errors = obs_metrics.validate_merged_snapshot(json.load(f))
    elif args.kind == "signature":
        for i, snap in enumerate(_jsonl(args.path)):
            errors += [
                f"line {i}: {e}"
                for e in obs_signature.validate_signature(snap)
            ]
    elif args.kind == "sentinel":
        errors = obs_sentinel.validate_sentinel(_jsonl(args.path))
    else:  # audit
        try:
            errors = obs_audit.validate_audit(obs_audit.read_audit(args.path))
        except ValueError as e:
            errors = [str(e)]
    for e in errors:
        print(f"invalid: {e}", file=sys.stderr)
    if not errors:
        print(f"{args.path}: valid {args.kind}")
    return 1 if errors else 0


def cmd_metrics(args) -> int:
    with open(args.path) as f:
        snaps = [json.loads(line) for line in f if line.strip()]
    if not snaps:
        print("no snapshots", file=sys.stderr)
        return 1
    for snap in snaps:
        errors = obs_metrics.validate_snapshot(snap)
        if errors:
            for e in errors:
                print(f"invalid: {e}", file=sys.stderr)
            return 1
        print(f"snapshot ts={snap['ts']:.3f}")
        for name in sorted(snap["counters"]):
            print(f"  {name:<28} {snap['counters'][name]}")
        for name in sorted(snap["histograms"]):
            h = snap["histograms"][name]
            print(
                f"  {name:<28} n={h['count']}"
                f" p50={h['p50']:.6f} p95={h['p95']:.6f}"
            )
        decisions = snap["counters"].get("tuner/decisions", 0)
        if decisions:
            rates = {
                key.split(".", 1)[1]: val / decisions
                for key, val in snap["counters"].items()
                if key.startswith("tuner/pick.")
            }
            pretty = ", ".join(
                f"{t}={r:.2%}" for t, r in sorted(rates.items())
            )
            print(f"  tier rates: {pretty}")
    return 0


def cmd_signature(args) -> int:
    snaps = _jsonl(args.path)
    if not snaps:
        print("no signature snapshots", file=sys.stderr)
        return 1
    errors = []
    for i, snap in enumerate(snaps):
        errors += [
            f"line {i}: {e}" for e in obs_signature.validate_signature(snap)
        ]
    if errors:
        for e in errors:
            print(f"invalid: {e}", file=sys.stderr)
        return 1
    grid = obs_signature.overlay(snaps)
    observed = sorted(
        {sched for row in grid.values() for sched in row}
    )
    print(
        f"{len(snaps)} snapshot(s), {len(grid)} (family, scenario) rows, "
        f"{len(observed)} schedules observed"
    )
    for (family, scenario) in sorted(grid):
        row = grid[(family, scenario)]
        print(f"\n{family} :: {scenario}")
        for sched in observed:
            agg = row.get(sched)
            if agg is None:
                print(f"  {sched:<18} -")
                continue
            fracs = ", ".join(
                f"{k}={v:.1%}"
                for k, v in sorted(
                    agg["loss_fractions"].items(),
                    key=lambda kv: -kv[1],
                )
                if v > 0.0
            )
            print(
                f"  {sched:<18} n={agg['count']:<6}"
                f" mean={agg['mean_total_s'] * 1e3:.4f}ms"
                f"  dominant={agg['dominant']}"
                + (f"  [{fracs}]" if fracs else "")
            )
    return 0


def cmd_audit(args) -> int:
    path = args.path or obs_audit.default_audit_path()
    try:
        records = obs_audit.read_audit(path)
    except FileNotFoundError:
        print(f"no audit log at {path}", file=sys.stderr)
        return 1
    errors = obs_audit.validate_audit(records)
    if errors:
        for e in errors:
            print(f"invalid: {e}", file=sys.stderr)
        return 1
    for r in records:
        print(
            f"{r['kind']:<7} {r['machine']:<18} g{r['group']}"
            f" m{r['m']} n{r['n']} k{r['k']}"
            f" -> {r['schedule']:<18} [{r['source']}]"
        )
    if args.replay:
        res = obs_audit.replay(records, backend=args.backend)
        print(json.dumps(res.to_json(), indent=2))
        return 0 if res.ok else 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scripts.trace",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    tl = sub.add_parser("timeline", help="render schedule timelines")
    tl.add_argument(
        "--scenario", nargs="*", default=[],
        help=f"Table-I scenario names ({', '.join(SCENARIOS)})",
    )
    tl.add_argument(
        "--gemm", nargs=3, type=int, metavar=("M", "N", "K"),
        help="ad-hoc GEMM shape (dtype_bytes=2)",
    )
    tl.add_argument(
        "--schedule", nargs="+", default=["all"],
        help="schedule values, or 'all' for every studied schedule",
    )
    tl.add_argument("--machine", default=TPU_V5E.name)
    tl.add_argument(
        "--group", type=int, default=0,
        help="retarget the machine at this overlap-group size",
    )
    tl.add_argument("--no-dma", action="store_true")
    tl.add_argument("--out", default="timeline.json")
    tl.set_defaults(fn=cmd_timeline)

    va = sub.add_parser("validate", help="schema-validate an export")
    va.add_argument("path")
    va.add_argument(
        "--kind",
        choices=(
            "trace", "metrics", "audit", "signature", "sentinel", "merged",
        ),
        default="trace",
    )
    va.set_defaults(fn=cmd_validate)

    sg = sub.add_parser(
        "signature",
        help="overlay streamed inefficiency signatures on the schedule grid",
    )
    sg.add_argument("path", help="signature snapshot JSONL (REPRO_SIGNATURES)")
    sg.set_defaults(fn=cmd_signature)

    me = sub.add_parser("metrics", help="summarize a metrics JSONL stream")
    me.add_argument("path")
    me.set_defaults(fn=cmd_metrics)

    au = sub.add_parser("audit", help="print / replay a decision-audit log")
    au.add_argument(
        "path", nargs="?", default=None,
        help="audit JSONL (default: decisions-torch.jsonl beside the cache)",
    )
    au.add_argument(
        "--replay", action="store_true",
        help="re-derive every pick offline and check it reproduces",
    )
    au.add_argument("--backend", default="numpy")
    au.set_defaults(fn=cmd_audit)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
