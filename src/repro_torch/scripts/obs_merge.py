"""Fleet-wide observability merge: union per-host metrics / trace exports
(port of the reference's ``scripts/obs_merge.py``).

A multi-host sweep (``python -m repro_torch.scripts.sweep --host-index $I
--host-count N``) or a serving fleet with ``REPRO_HOST_INDEX`` set per
host leaves one host-stamped metrics JSONL and/or one Perfetto trace JSON
per host.  This tool unions them into a single fleet view:

``metrics``
    Take the *last* snapshot line of each per-host metrics stream
    (snapshots are cumulative — the last line subsumes the earlier
    ones), union them via :func:`repro_torch.obs.metrics.merge_snapshots`
    (bit-exact counter sums; exact percentiles when the exports carry
    reservoirs, count-weighted approximations flagged ``approx``
    otherwise), and write one merged snapshot::

        PYTHONPATH=src python -m repro_torch.scripts.obs_merge metrics \\
            host0.metrics.jsonl host1.metrics.jsonl --out fleet.json

``traces``
    Union per-host Chrome trace exports into one timeline via
    :func:`repro_torch.obs.trace.merge_traces`: host clock anchors align
    the timestamps onto the earliest host's epoch and pids are remapped so
    every host renders as its own labeled process group in Perfetto::

        PYTHONPATH=src python -m repro_torch.scripts.obs_merge traces \\
            host0.trace.json host1.trace.json --out fleet_trace.json

Both outputs revalidate under the corresponding schema
(``python -m repro_torch.scripts.trace validate --kind merged`` /
``--kind trace``).  Everything runs on the host.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def last_snapshot(path: str) -> dict | None:
    """Last JSON line of one host's cumulative metrics stream."""
    last = None
    with open(path) as f:
        for line in f:
            if line.strip():
                last = json.loads(line)
    return last


def cmd_metrics(args) -> int:
    snaps = []
    for path in args.paths:
        snap = last_snapshot(path)
        if snap is None:
            print(f"# skipping {path}: no snapshot lines", file=sys.stderr)
            continue
        errors = obs_metrics.validate_snapshot(snap)
        if errors:
            for e in errors:
                print(f"invalid input {path}: {e}", file=sys.stderr)
            return 1
        snaps.append(snap)
    if not snaps:
        print("nothing to merge", file=sys.stderr)
        return 1
    merged = obs_metrics.merge_snapshots(snaps)
    errors = obs_metrics.validate_merged_snapshot(merged)
    if errors:
        for e in errors:
            print(f"merged snapshot invalid: {e}", file=sys.stderr)
        return 1
    text = json.dumps(merged, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    approx = sum(
        1 for h in merged["histograms"].values() if h.get("approx")
    )
    print(
        f"# merged {merged['hosts']} host snapshot(s): "
        f"{len(merged['counters'])} counters, "
        f"{len(merged['histograms'])} histograms"
        + (f" ({approx} approximate percentiles)" if approx else ""),
        file=sys.stderr,
    )
    return 0


def cmd_traces(args) -> int:
    traces = []
    for path in args.paths:
        with open(path) as f:
            obj = json.load(f)
        errors = obs_trace.validate_trace(obj)
        if errors:
            for e in errors:
                print(f"invalid input {path}: {e}", file=sys.stderr)
            return 1
        traces.append(obj)
    merged = obs_trace.merge_traces(traces)
    errors = obs_trace.validate_trace(merged)
    if errors:
        for e in errors:
            print(f"merged trace invalid: {e}", file=sys.stderr)
        return 1
    text = json.dumps(merged)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    print(
        f"# merged {len(traces)} trace(s): "
        f"{len(merged['traceEvents'])} events",
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scripts.obs_merge",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    me = sub.add_parser("metrics", help="union per-host metrics snapshots")
    me.add_argument("paths", nargs="+", metavar="JSONL")
    me.add_argument("--out", default=None, metavar="PATH")
    me.set_defaults(fn=cmd_metrics)

    tr = sub.add_parser("traces", help="union per-host Perfetto traces")
    tr.add_argument("paths", nargs="+", metavar="JSON")
    tr.add_argument("--out", default=None, metavar="PATH")
    tr.set_defaults(fn=cmd_traces)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
