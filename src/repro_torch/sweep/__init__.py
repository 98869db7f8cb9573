"""repro_torch.sweep — sharded design-space sweeps over hosts (port of
``repro.sweep``).

The scenario axis of the FiCCO design-space grid is embarrassingly
parallel; this package cuts it with deterministic
:class:`~repro_torch.sweep.plan.ShardPlan`\\ s, evaluates shards through any
registered engine (:mod:`repro_torch.core.engine`; ``"torch"`` runs each
shard on the card), round-robin over identical host processes, and
either gathers the shards back into one bit-identical
:class:`~repro_torch.core.engine.GridResult` or streams compact per-shard
summaries (1e6-1e7-point sweeps).

The three-line sharded sweep::

    from repro_torch.sweep import sweep_grid, synthetic_batch
    res = sweep_grid(synthetic_batch(100_000), machines, backend="torch",
                     num_shards=16, mode="reduce")
    print(res.summary())

The card-resident pieces (:mod:`repro_torch.sweep.device`: counter-based
synthesis, the mixed-precision engine's backend, the fused
synthesis + grid + statistics sweep) are exported lazily below, and the
command lines are ``python -m repro_torch.scripts.sweep`` (per-shard JSON
streaming, multi-host owner mapping, device-parallel evaluation) and
``python -m repro_torch.scripts.merge_sweep``.
"""

from repro_torch.sweep.plan import (
    ShardPlan,
    owner_of,
    plan_shards,
    shards_for_host,
)
from repro_torch.sweep.runner import (
    ShardSummary,
    SweepResult,
    concat_batches,
    concat_grid_results,
    merge_summaries,
    shard_batch,
    summarize_shard,
    sweep_grid,
)
from repro_torch.sweep.synth import (
    ServeRequest,
    drifting_request_stream,
    synthetic_batch,
    synthetic_ragged_batch,
)

# The card-resident pieces (repro_torch.sweep.device) are exported lazily
# (PEP 562), as the reference's are: importing the package stays cheap.
_DEVICE_EXPORTS = (
    "host_batch",
    "host_ragged_batch",
    "device_batch",
    "device_ragged_batch",
    "evaluate_mixed_grid",
    "dispatch_mixed_grid",
    "sweep_device_stats",
    "device_merge_stats",
)


def __getattr__(name):
    if name in _DEVICE_EXPORTS:
        from repro_torch.sweep import device

        return getattr(device, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )


def __dir__():
    return sorted(list(globals()) + list(_DEVICE_EXPORTS))


__all__ = [
    "ShardPlan",
    "plan_shards",
    "owner_of",
    "shards_for_host",
    "ShardSummary",
    "SweepResult",
    "shard_batch",
    "concat_batches",
    "concat_grid_results",
    "summarize_shard",
    "merge_summaries",
    "sweep_grid",
    "synthetic_batch",
    "synthetic_ragged_batch",
    "ServeRequest",
    "drifting_request_stream",
    *_DEVICE_EXPORTS,
]
