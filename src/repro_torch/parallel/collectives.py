"""Collectives of a logical tensor-parallel group, over the stacked rank dim.

The reference's schedules call ``lax.all_gather`` and ``lax.ppermute``
inside ``shard_map``; XLA lowers them to transfers between devices.  A
:class:`~repro_torch.parallel.sharding.TPGroup` holds its ranks on one
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


def ppermute(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with ``perm = [(i, (i + shift) % g)]``: rank r
    receives rank (r - shift)'s block.  x: (g, ...) -> (g, ...), a copy."""
    g = x.shape[0]
    src = (torch.arange(g, device=x.device) - shift) % g
    return x[src]


__all__ = ["all_gather", "ppermute"]
