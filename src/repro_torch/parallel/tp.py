"""Tensor-sequence-parallel linears with FiCCO overlap (paper Fig. 3).

Port of ``repro.parallel.tp``.  ``tp_ficco_linear`` is the integration
point: the activation is cut sequence-major over the active
:class:`~repro_torch.parallel.sharding.TPGroup` (Megatron sequence
parallelism), the weight is column-sharded, and the data-dependent
AG->GEMM runs as a FiCCO schedule.  Backend ``"dma"`` with schedule
``auto`` or ``uniform-fused-1d`` runs the copy-engine exchange and the K1
step GEMM (:func:`repro_torch.kernels.ops.ag_matmul_dma`); every other
mode goes through :func:`repro_torch.overlap.api.ficco_linear`, deciding
for :data:`~repro_torch.core.machine.H100_SXM`.

On a :class:`~repro_torch.parallel.group.RankGroup` the same function is
one rank's ``shard_map`` body: the activation is the rank's sequence
block of the residual stream (the model cuts it by sequence), the weight
this rank's column block, and the rank returns its column block of the
output over the whole sequence; the schedule's all-gathers transpose to
reduce-scatters, so training runs per rank too.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import OverlapConfig
from repro_torch.core.machine import H100_SXM
from repro_torch.core.schedule_types import Schedule
from repro_torch.kernels.ops import ag_matmul_dma
from repro_torch.overlap.api import ficco_linear
from repro_torch.parallel.group import RankGroup
from repro_torch.parallel.sharding import active_group, shard_columns


def _mode_to_schedule(mode: str):
    if mode == "ficco_auto":
        return "auto"
    if mode == "ficco_autotune":
        return "autotune"
    return mode  # Schedule enum value string or "serial"/"shard_p2p"


def overlap_applicable(x: torch.Tensor, w: torch.Tensor) -> bool:
    group = active_group()
    if group is None or group.size <= 1:
        return False
    g = group.size
    b, s, d = x.shape
    return s % g == 0 and w.shape[1] % g == 0


def tp_ficco_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    overlap: OverlapConfig,
) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, F) with the FiCCO-overlapped AG->GEMM.

    Rank r holds the sequence block r of every batch row, ordered
    seq-major ((S/g) * B rows) so the all-gather's rank-major
    concatenation rebuilds the global seq order, and computes the full-S
    x (F/g) output block r.  The ranks' blocks are laid side by side into
    the (B, S, F) result, as ``shard_map``'s ``P(None, None, "model")``
    output would be.  On a ``RankGroup`` x is the rank's (B, S/g, D)
    block and w its column block: the result is its (B, S, F/g) block.
    """
    group = active_group()
    g = group.size
    b, s, d = x.shape
    f = w.shape[1]
    schedule = _mode_to_schedule(overlap.mode)
    dma = overlap.backend == "dma" and schedule in (
        "auto", Schedule.UNIFORM_FUSED_1D.value)
    if isinstance(group, RankGroup):
        return _rank_linear(x, w, schedule, dma, group)
    # (B, S, D) -> (g, S/g * B, D): rank-major, then seq-major rows.
    rows = x.view(b, g, s // g, d).permute(1, 2, 0, 3).reshape(g, -1, d)
    if dma and rows.shape[1] % g == 0:
        out = ag_matmul_dma(rows, shard_columns(w, g), group=group)
    else:
        out = ficco_linear(
            rows, shard_columns(w, g), schedule=schedule, machine=H100_SXM
        )
    # (g, S * B, F/g) -> (B, S, g, F/g) -> (B, S, F)
    return out.view(g, s, b, f // g).permute(2, 1, 0, 3).reshape(b, s, f)


def _rank_linear(x, w, schedule, dma: bool, group: RankGroup):
    """x: (B, S/g, D), this rank's sequence block; w: (D, F/g), this
    rank's columns -> (B, S, F/g), this rank's column block over the
    whole sequence (the reference's ``body``).  Under grad the schedule's
    all-gathers reduce-scatter the cotangent: every rank gets the sum of
    the ranks' parts for its block."""
    g = group.size
    b, s_loc, d = x.shape
    # The rank's rows, seq-major ((S/g) * B rows), so the all-gather's
    # rank-major concatenation rebuilds the global seq order.
    rows = x.transpose(0, 1).reshape(-1, d)
    if dma and rows.shape[0] % g == 0:
        out = ag_matmul_dma(rows, w, group=group)
    else:
        out = ficco_linear(rows, w, schedule=schedule, machine=H100_SXM)
    # (S * B, F/g) -> (B, S, F/g)
    return out.view(g * s_loc, b, w.shape[1]).transpose(0, 1)


__all__ = ["overlap_applicable", "tp_ficco_linear"]
