"""Collectives of a logical tensor-parallel group, over the stacked rank dim.

The reference's schedules call ``lax.all_gather``, ``lax.ppermute`` and
``lax.all_to_all`` inside ``shard_map``; XLA lowers them to transfers
between devices.  A :class:`~repro_torch.parallel.sharding.TPGroup` holds
its ranks on one
device, stacked on dim 0, so each collective here materialises every
rank's copy of the result: the bytes move as the collective would move
them, and no rank reads another rank's slot afterwards.  With a group over
several cards these bodies become NCCL calls (ROADMAP A9).
"""

from __future__ import annotations

import torch


def all_gather(x: torch.Tensor, *, tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather(x, axis=0[, tiled])`` on every rank.

    x: (g, m, ...), rank r's block at [r].  Untiled -> (g, g, m, ...),
    out[r, s] = x[s]; tiled -> (g, g * m, ...), the blocks concatenated
    in rank order on every rank.
    """
    g = x.shape[0]
    out = x.unsqueeze(0).expand(g, *x.shape).contiguous()
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
    return x.transpose(0, 1).contiguous()


def ppermute(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with ``perm = [(i, (i + shift) % g)]``: rank r
    receives rank (r - shift)'s block.  x: (g, ...) -> (g, ...), a copy."""
    g = x.shape[0]
    src = (torch.arange(g, device=x.device) - shift) % g
    return x[src]


__all__ = ["all_gather", "all_to_all", "ppermute"]
