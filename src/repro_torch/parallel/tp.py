"""Tensor-sequence-parallel linears with FiCCO overlap (paper Fig. 3).

Port of ``repro.parallel.tp``.  ``tp_ficco_linear`` is the integration
point: the activation is cut sequence-major over the active
:class:`~repro_torch.parallel.sharding.TPGroup` (Megatron sequence
parallelism), the weight is column-sharded, and the data-dependent
AG->GEMM runs as a FiCCO schedule.  Backend ``"dma"`` with schedule
``auto`` or ``uniform-fused-1d`` runs the copy-engine exchange and the K1
step GEMM (:func:`repro_torch.kernels.ops.ag_matmul_dma`).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import OverlapConfig
from repro_torch.parallel.sharding import active_group, shard_columns

UNIFORM_FUSED_1D = "uniform-fused-1d"


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
    output would be.
    """
    group = active_group()
    g = group.size
    b, s, d = x.shape
    f = w.shape[1]
    schedule = _mode_to_schedule(overlap.mode)
    # (B, S, D) -> (g, S/g * B, D): rank-major, then seq-major rows.
    rows = x.view(b, g, s // g, d).permute(1, 2, 0, 3).reshape(g, -1, d)
    if not (
        overlap.backend == "dma"
        and schedule in ("auto", UNIFORM_FUSED_1D)
        and rows.shape[1] % g == 0
    ):
        raise NotImplementedError(
            f"overlap backend {overlap.backend!r} with schedule "
            f"{schedule!r} runs ficco_linear, whose schedules are not ported "
            "yet (ROADMAP queue A, item 1: overlap/schedules.py + "
            "overlap/api.py)"
        )
    from repro_torch.kernels.ops import ag_matmul_dma

    out = ag_matmul_dma(rows, shard_columns(w, g), group=group)
    # (g, S * B, F/g) -> (B, S, g, F/g) -> (B, S, F)
    return out.view(g, s, b, f // g).permute(2, 1, 0, 3).reshape(b, s, f)


__all__ = ["overlap_applicable", "tp_ficco_linear"]
