"""Command lines of the port, run as modules (``python -m
repro_torch.scripts.<name>``).

  * :mod:`repro_torch.scripts.sweep` — the sharded design-space sweep
    driver (per-shard JSON streaming, multi-host owner mapping, the
    ``"mixed"`` engine, on-card synthesis, device-parallel shards).
  * :mod:`repro_torch.scripts.merge_sweep` — the gather-side aggregator
    of the per-host sweep streams.
  * :mod:`repro_torch.scripts.hillclimb` — the dry-run hillclimb: named
    config variants of three (arch x shape) pairs through
    :func:`repro_torch.launch.dryrun.dryrun_one`.
  * :mod:`repro_torch.scripts.trace` — the observability command line:
    schedule timelines, schema validation of every export kind, the
    metrics and signature summaries, the decision-audit log and its
    offline replay.
  * :mod:`repro_torch.scripts.obs_merge` — the fleet merge of per-host
    metrics snapshots and Perfetto traces.
  * :mod:`repro_torch.scripts.clear_autotune_cache` — removes the port's
    persistent tuner store (``autotune-torch-v*.json``) and nothing else.
"""
