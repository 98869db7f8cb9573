"""Command lines of the port, run as modules (``python -m
repro_torch.scripts.<name>``).

  * :mod:`repro_torch.scripts.sweep` — the sharded design-space sweep
    driver (per-shard JSON streaming, multi-host owner mapping, the
    ``"mixed"`` engine, on-card synthesis, device-parallel shards).
  * :mod:`repro_torch.scripts.merge_sweep` — the gather-side aggregator
    of the per-host sweep streams.
"""
