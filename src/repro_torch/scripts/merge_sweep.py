"""Gather-side aggregator for multi-host sweep streams (port of the
reference's ``scripts/merge_sweep.py``).

Every host of a multi-controller sweep (``python -m
repro_torch.scripts.sweep --host-index $I --host-count N``) streams one
JSON line per finished shard plus a final host summary into its own
``sweep_host$I.jsonl``.  This tool merges any set of those streams into
one host-complete summary: the aggregator is where unclaimed shards
become visible for re-dispatch.  It runs on the host only.

Usage::

    PYTHONPATH=src python -m repro_torch.scripts.merge_sweep \
        sweep_host*.jsonl [--out merged.json] [--expect-shards N] [--strict]

Duplicate shard reports (a retried host re-evaluating its shards) are
deduplicated by shard id — the deterministic plan makes retries
idempotent, so the first report wins.  ``--expect-shards`` (or, when
absent, the plan shard count any surviving host summary carries — every
host derives the same plan) defines completeness; missing shard ids are
listed in the output and, with ``--strict``, fail the process with exit
code 3.  When neither source is available (every host died before its
summary line) trailing lost shards are undetectable, so the merge is
marked incomplete.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.sweep import ShardSummary, merge_summaries


def parse_stream(lines):
    """(shard summaries, host summaries) from one host's JSONL stream."""
    shards, hosts = [], []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail line of a dying host: skip, keep merging
        if "shard_summary" in rec:
            shards.append(ShardSummary(**rec["shard_summary"]))
        elif "host_summary" in rec:
            hosts.append(rec["host_summary"])
    return shards, hosts


def merge_streams(streams, expect_shards=None):
    """Merge parsed per-host streams into one host-complete summary dict.

    ``streams`` is a list of (shard_summaries, host_summaries) pairs.
    """
    by_shard = {}
    dupes = 0
    hosts = []
    for shards, host_summaries in streams:
        for s in shards:
            if s.shard in by_shard:
                dupes += 1
                continue
            by_shard[s.shard] = s
        hosts.extend(host_summaries)

    # No silent precision mixing: a float32/bfloat16 stream's summaries
    # are not comparable with a float64 one's (the same rule
    # GateStats.from_json enforces for bin edges).  Streams written
    # before dtype recording existed count as float64.
    dtypes = {h.get("dtype", "float64") for h in hosts}
    if len(dtypes) > 1:
        raise ValueError(
            f"refusing to merge streams with mismatched dtypes: "
            f"{sorted(dtypes)}"
        )

    owned = set()
    plan_counts = set()
    for h in hosts:
        owned.update(h.get("owned_shards", ()))
        if h.get("plan_shards") is not None:
            plan_counts.add(int(h["plan_shards"]))
    n_expected = expect_shards
    known = n_expected is not None
    if n_expected is None and plan_counts:
        # Every host derives the same deterministic plan; any surviving
        # host summary therefore knows the full shard count — even when
        # the host owning the highest shard ids died without a trace.
        n_expected = max(plan_counts)
        known = True
    if n_expected is None:
        # No plan information at all (every host died before its
        # summary line): the best available lower bound.  ``complete``
        # stays False below — trailing lost shards are undetectable.
        seen = owned | set(by_shard)
        n_expected = (max(seen) + 1) if seen else 0
    missing = sorted(set(range(n_expected)) - set(by_shard))

    merged = merge_summaries(by_shard.values())
    if dtypes:
        merged["dtype"] = dtypes.pop()

    # Per-host throughput and its spread: the load-imbalance signal a
    # re-dispatcher reads.  skew = slowest/fastest as a ratio >= 1; a
    # skew of 2 means the slowest host did half the scenarios/s of the
    # fastest and the round-robin owner map should be re-weighted.
    throughput = {}
    for h in hosts:
        wall = h.get("wall_seconds")
        idx = h.get("host_index")
        if idx is None or not wall or wall <= 0:
            continue
        throughput[str(idx)] = h.get("n_scenarios", 0) / wall
    merged["host_throughput"] = throughput
    rates = [r for r in throughput.values() if r > 0]
    merged["host_throughput_skew"] = (
        max(rates) / min(rates) if len(rates) >= 2 else None
    )
    merged["hosts_reporting"] = len(hosts)
    merged["duplicate_shard_reports"] = dupes
    merged["expected_shards"] = n_expected
    merged["expected_shards_known"] = known
    merged["missing_shards"] = missing
    merged["complete"] = known and not missing
    return merged


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scripts.merge_sweep",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "streams", nargs="+", metavar="JSONL",
        help="per-host sweep streams (sweep_host*.jsonl)",
    )
    ap.add_argument(
        "--out", default=None, metavar="PATH",
        help="write the merged summary JSON here (stdout if unset)",
    )
    ap.add_argument(
        "--expect-shards", type=int, default=None,
        help="total shard count of the plan (default: inferred from the "
        "host summaries' owner lists)",
    )
    ap.add_argument(
        "--strict", action="store_true",
        help="exit 3 if any expected shard is unreported (the signal a "
        "re-dispatcher keys off)",
    )
    ap.add_argument(
        "--metrics", nargs="+", default=None, metavar="JSONL",
        help="per-host metrics exports (the sweep's --metrics): their "
        "last snapshots are unioned (repro_torch.obs.metrics."
        "merge_snapshots) and "
        "folded into the output under 'metrics'",
    )
    args = ap.parse_args(argv)

    streams = []
    for path in args.streams:
        with open(path) as f:
            streams.append(parse_stream(f))
    try:
        merged = merge_streams(streams, expect_shards=args.expect_shards)
    except ValueError as e:
        print(f"# REFUSED: {e}", file=sys.stderr)
        sys.exit(4)

    if args.metrics:
        from repro_torch.obs import metrics as obs_metrics

        snaps = []
        for path in args.metrics:
            last = None
            with open(path) as f:
                for line in f:
                    if line.strip():
                        last = json.loads(line)
            if last is not None:
                snaps.append(last)
        if snaps:
            merged["metrics"] = obs_metrics.merge_snapshots(snaps)

    text = json.dumps(merged, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    if not merged["expected_shards_known"]:
        print(
            "# WARNING: no host summary carried the plan's shard count "
            "and --expect-shards was not given; trailing lost shards "
            "are undetectable (treated as incomplete)",
            file=sys.stderr,
        )
        if args.strict:
            sys.exit(3)
    if merged["missing_shards"]:
        print(
            f"# INCOMPLETE: {len(merged['missing_shards'])} of "
            f"{merged['expected_shards']} shards unreported: "
            f"{merged['missing_shards']}",
            file=sys.stderr,
        )
        if args.strict:
            sys.exit(3)
    else:
        print(
            f"# complete: {merged['n_shards']} shards, "
            f"{merged['n_scenarios']} scenarios from "
            f"{merged['hosts_reporting']} host(s)",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
