"""The six FiCCO schedules per rank of a :class:`RankGroup`.

The counterpart of :mod:`repro_torch.overlap.schedules` for a group whose
ranks are processes: each function is one rank's ``shard_map`` body of
``repro.overlap.schedules``, one for one, with the same row arithmetic.
It takes this rank's blocks and the group:

    x: (m_s, K), this rank's rows;  w: (K, n_local), its columns
    out = all_gather_M(x) @ w                  # (g * m_s, n_local)

and its collectives are :mod:`repro_torch.parallel.collectives`' per-rank
forms (``group=``), so :func:`~repro_torch.parallel.collectives.counting`
records on each rank what ``parse_collectives`` reads from the
reference's compiled per-device program.  As in the stacked port, the
GEMMs are plain ``torch.matmul`` except ``ficco_uniform_fused_2d``'s,
which folds each step into its fp32 accumulator with K2
(:func:`repro_torch.kernels.ops.matmul_accumulate`).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.schedule_types import Schedule
from repro_torch.kernels import ops
from repro_torch.parallel.collectives import all_gather, ppermute
from repro_torch.parallel.group import RankGroup


def _out(x: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.empty((rows, w.shape[-1]),
                       dtype=torch.promote_types(x.dtype, w.dtype),
                       device=x.device)


def _chunk_rows(x: torch.Tensor, g: int) -> torch.Tensor:
    """(m_s, K) -> (g, m_c, K) row chunks: one per overlap step."""
    m_s, k = x.shape
    if m_s % g:
        raise ValueError(f"shard rows {m_s} not divisible by group {g}")
    return x.reshape(g, m_s // g, k)


def serial_ag_matmul(x: torch.Tensor, w: torch.Tensor,
                     group: RankGroup) -> torch.Tensor:
    """Paper Fig. 3(b): all-gather the input shards, then one big GEMM."""
    return torch.matmul(all_gather(x, tiled=True, group=group), w)


def shard_p2p_matmul(x: torch.Tensor, w: torch.Tensor,
                     group: RankGroup) -> torch.Tensor:
    """Shard-granularity ring (PyTorch AsyncTP, paper Fig. 3c): each step
    sends the held shard to the right neighbour while its GEMM runs."""
    g, me = group.size, group.rank
    m_s = x.shape[0]
    out = _out(x, w, g * m_s)
    buf = x
    for step in range(g):
        src = (me - step) % g  # whose shard this rank holds
        out[src * m_s:(src + 1) * m_s] = torch.matmul(buf, w)
        if step != g - 1:
            buf = ppermute(buf, 1, group=group)
    return out


def ficco_uniform_fused_1d(x: torch.Tensor, w: torch.Tensor,
                           group: RankGroup) -> torch.Tensor:
    """uniform-fused-1D: step s exchanges chunk s with every peer, runs one
    (g * m_c, K) @ (K, n_local) GEMM and scatters row block d to row
    d * m_s + s * m_c."""
    g = group.size
    m_s, k = x.shape
    n_local = w.shape[-1]
    m_c = m_s // g
    chunks = _chunk_rows(x, g)
    out = _out(x, w, g * m_s)
    out_steps = out.view(g, g, m_c, n_local)  # [source rank, step]
    for s in range(g):
        gathered = all_gather(chunks[s], group=group)  # (g, m_c, K)
        step_out = torch.matmul(gathered.view(g * m_c, k), w)
        out_steps[:, s] = step_out.view(g, m_c, n_local)
    return out


def ficco_hetero_fused_1d(x: torch.Tensor, w: torch.Tensor,
                          group: RankGroup) -> torch.Tensor:
    """hetero-fused-1D: the local shard's GEMM first, then per step one
    GEMM over the g - 1 remote chunks (slot j from peer me + 1 + j)."""
    g, me = group.size, group.rank
    m_s, k = x.shape
    n_local = w.shape[-1]
    m_c = m_s // g
    out = _out(x, w, g * m_s)
    out[me * m_s:(me + 1) * m_s] = torch.matmul(x, w)
    chunks = _chunk_rows(x, g)
    out_steps = out.view(g, g, m_c, n_local)
    for s in range(g):
        gathered = all_gather(chunks[s], group=group)
        rolled = torch.roll(gathered, -(me + 1), dims=0)[:g - 1]
        step_out = torch.matmul(rolled.reshape((g - 1) * m_c, k), w)
        step_out = step_out.view(g - 1, m_c, n_local)
        for j in range(g - 1):
            out_steps[(me + 1 + j) % g, s] = step_out[j]
    return out


def ficco_hetero_unfused_1d(x: torch.Tensor, w: torch.Tensor,
                            group: RankGroup) -> torch.Tensor:
    """hetero-unfused-1D: as hetero-fused, one GEMM per remote chunk."""
    g, me = group.size, group.rank
    m_s, k = x.shape
    n_local = w.shape[-1]
    m_c = m_s // g
    out = _out(x, w, g * m_s)
    out[me * m_s:(me + 1) * m_s] = torch.matmul(x, w)
    chunks = _chunk_rows(x, g)
    out_steps = out.view(g, g, m_c, n_local)
    for s in range(g):
        gathered = all_gather(chunks[s], group=group)
        rolled = torch.roll(gathered, -(me + 1), dims=0)
        for j in range(g - 1):
            out_steps[(me + 1 + j) % g, s] = torch.matmul(rolled[j], w)
    return out


def ficco_uniform_fused_2d(x: torch.Tensor, w: torch.Tensor,
                           group: RankGroup) -> torch.Tensor:
    """uniform-fused-2D: step s gathers the full-M (M, K/g) panel of K
    slice s and folds panel @ w_slice into the fp32 accumulator (K2)."""
    g = group.size
    m_s, k = x.shape
    if k % g:
        raise ValueError(f"K={k} not divisible by group {g}")
    k_c = k // g
    acc = torch.zeros((g * m_s, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for chunk, w_slice in zip(x.split(k_c, dim=1), w.split(k_c, dim=0)):
        panel = all_gather(chunk, tiled=True, group=group)  # (M, K/g)
        acc = ops.matmul_accumulate(acc, panel, w_slice)
    return acc.to(torch.promote_types(x.dtype, w.dtype))


RANK_SCHEDULE_FNS: dict[Schedule, Callable[..., torch.Tensor]] = {
    Schedule.SERIAL: serial_ag_matmul,
    Schedule.SHARD_P2P: shard_p2p_matmul,
    Schedule.UNIFORM_FUSED_1D: ficco_uniform_fused_1d,
    Schedule.HETERO_FUSED_1D: ficco_hetero_fused_1d,
    Schedule.HETERO_UNFUSED_1D: ficco_hetero_unfused_1d,
    Schedule.UNIFORM_FUSED_2D: ficco_uniform_fused_2d,
}


def run_rank_schedule(schedule: Schedule, x: torch.Tensor, w: torch.Tensor,
                      group: RankGroup) -> torch.Tensor:
    return RANK_SCHEDULE_FNS[schedule](x, w, group)


__all__ = [
    "RANK_SCHEDULE_FNS",
    "run_rank_schedule",
    "serial_ag_matmul",
    "shard_p2p_matmul",
    "ficco_uniform_fused_1d",
    "ficco_hetero_fused_1d",
    "ficco_hetero_unfused_1d",
    "ficco_uniform_fused_2d",
]
