"""Collectives of a logical tensor-parallel group, over the stacked rank dim.

The reference's schedules call ``lax.all_gather``, ``lax.ppermute`` and
``lax.all_to_all`` inside ``shard_map``; XLA lowers them to transfers
between devices.  A :class:`~repro_torch.parallel.sharding.TPGroup` holds
its ranks on one
device, stacked on dim 0, so each collective here materialises every
rank's copy of the result: the bytes move as the collective would move
them, and no rank reads another rank's slot afterwards.  With a group over
several cards these bodies become NCCL calls (ROADMAP A9).

:func:`counting` records what the collectives move, as the reference's
``roofline.analysis.parse_collectives`` reads it from a compiled per-device
program: each call's output bytes on one rank, by the HLO kind name.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass
class CollectiveStats:
    """Bytes and calls by kind (``all-gather``, ``all-to-all``,
    ``collective-permute``), each call's bytes its output on one rank."""

    bytes_by_kind: dict[str, float]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


_ACTIVE: CollectiveStats | None = None


@contextlib.contextmanager
def counting():
    """Count the collectives called inside the block; yields the
    :class:`CollectiveStats` they add to.

    Each :func:`all_gather`, :func:`all_to_all` and :func:`ppermute` call
    adds its per-rank output bytes (the stacked output's over the group
    size) under the reference's HLO kind.  Two things are not counted:
    a collective the autograd engine runs in a backward (the
    recomputation of a ``remat`` period included), and K3's and K4's
    exchanges, which are Pallas DMAs in the reference and no HLO
    collective.
    """
    global _ACTIVE
    outer, stats = _ACTIVE, CollectiveStats({}, {})
    _ACTIVE = stats
    try:
        yield stats
    finally:
        _ACTIVE = outer


def _record(kind: str, out: torch.Tensor) -> torch.Tensor:
    stats = _ACTIVE
    if stats is not None and torch._C._current_graph_task_id() == -1:
        nbytes = float(out.numel() // out.shape[0] * out.element_size())
        stats.bytes_by_kind[kind] = stats.bytes_by_kind.get(kind, 0.0) + nbytes
        stats.count_by_kind[kind] = stats.count_by_kind.get(kind, 0) + 1
    return out


def all_gather(x: torch.Tensor, *, tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather(x, axis=0[, tiled])`` on every rank.

    x: (g, m, ...), rank r's block at [r].  Untiled -> (g, g, m, ...),
    out[r, s] = x[s]; tiled -> (g, g * m, ...), the blocks concatenated
    in rank order on every rank.
    """
    g = x.shape[0]
    out = _record("all-gather", x.unsqueeze(0).expand(g, *x.shape)
                  .contiguous())
    if tiled:
        return out.view(g, g * x.shape[1], *x.shape[2:])
    return out


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0)`` on every rank.

    x: (g, g, ...), rank r's block s at [r, s] -> (g, g, ...): rank r's
    block s lands in rank s's slot r, out[s, r] = x[r, s], a copy.
    """
    if x.shape[1] != x.shape[0]:
        raise ValueError(f"all_to_all of {tuple(x.shape)}: dim 1 must be "
                         "the group size")
    return _record("all-to-all", x.transpose(0, 1).contiguous())


def ppermute(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with ``perm = [(i, (i + shift) % g)]``: rank r
    receives rank (r - shift)'s block.  x: (g, ...) -> (g, ...), a copy."""
    g = x.shape[0]
    src = (torch.arange(g, device=x.device) - shift) % g
    return _record("collective-permute", x[src])


__all__ = ["CollectiveStats", "counting", "all_gather", "all_to_all",
           "ppermute"]
