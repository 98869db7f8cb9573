"""Deterministic scenario-axis shard plans (port of ``repro.sweep.plan``).

The design-space grid is embarrassingly parallel over scenarios: every
``(scenario, machine, schedule)`` cell is computed from its own lane of
the batched array math, so cutting the scenario axis into contiguous
shards and evaluating them independently reproduces the unsharded
:class:`~repro_torch.core.engine.GridResult` bit for bit.

A :class:`ShardPlan` is pure arithmetic — no RNG, no process state — so
every host in a multi-host sweep derives the *same* plan from
``(n_scenarios, n_shards)`` and the round-robin owner mapping, and the
union of all hosts' shards tiles the scenario axis exactly once.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Contiguous split of ``n_scenarios`` lanes into ``n_shards`` shards.

    ``bounds[i]`` is shard i's half-open ``[start, stop)`` scenario
    range.  ``padded_size > 0`` marks an *equalized* plan (every shard
    evaluates exactly ``padded_size`` lanes, short shards padded at the
    tail) — what an SPMD split over devices needs; the padding lanes
    are trimmed before results are returned.
    """

    n_scenarios: int
    n_shards: int
    bounds: tuple[tuple[int, int], ...]
    padded_size: int = 0

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(stop - start for start, stop in self.bounds)

    @property
    def pad(self) -> int:
        """Total padded lanes across all shards (0 for exact plans)."""
        if not self.padded_size:
            return 0
        return self.padded_size * self.n_shards - self.n_scenarios


def plan_shards(
    n_scenarios: int, n_shards: int, *, equalize: bool = False
) -> ShardPlan:
    """Split the scenario axis into ``n_shards`` contiguous shards.

    Default: remainder lanes spread over the leading shards, so sizes
    differ by at most one and no padding exists.  ``equalize=True``:
    every shard spans ``ceil(S / n)`` lanes (trailing shards short or
    even empty, tracked via ``padded_size``) — the layout an SPMD
    evaluation pads to.
    """
    if n_scenarios < 0:
        raise ValueError(f"n_scenarios must be >= 0, got {n_scenarios}")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if equalize:
        size = -(-n_scenarios // n_shards) if n_scenarios else 0
        bounds = tuple(
            (
                min(i * size, n_scenarios),
                min((i + 1) * size, n_scenarios),
            )
            for i in range(n_shards)
        )
        return ShardPlan(n_scenarios, n_shards, bounds, padded_size=size)
    q, r = divmod(n_scenarios, n_shards)
    bounds = []
    start = 0
    for i in range(n_shards):
        stop = start + q + (1 if i < r else 0)
        bounds.append((start, stop))
        start = stop
    return ShardPlan(n_scenarios, n_shards, tuple(bounds))


def owner_of(shard: int, n_hosts: int) -> int:
    """Round-robin shard -> host owner mapping (deterministic)."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    return shard % n_hosts


def shards_for_host(
    plan: ShardPlan, host: int, n_hosts: int
) -> tuple[int, ...]:
    """Shard ids this host owns under the round-robin mapping."""
    if not 0 <= host < n_hosts:
        raise ValueError(f"host {host} outside [0, {n_hosts})")
    return tuple(
        i for i in range(plan.n_shards) if owner_of(i, n_hosts) == host
    )


__all__ = ["ShardPlan", "plan_shards", "owner_of", "shards_for_host"]
