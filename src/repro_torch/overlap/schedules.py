"""Executable FiCCO schedules over a logical group's stacked ranks.

Port of ``repro.overlap.schedules``.  The reference runs each schedule
inside ``shard_map``, one device per rank; here the ``g`` ranks of a
:class:`~repro_torch.parallel.sharding.TPGroup` are stacked on dim 0 and
one call runs all of them.  Every schedule implements the data-dependent
pattern of paper Fig. 3: the activation arrives row (M) sharded, the
weight is column (N) sharded and resident, and each rank computes the full
gathered-M times its local-N block:

    x: (g, m_s, K), rank r's rows;  w: (g, K, n_local), rank r's columns
    out[r] = all_gather_M(x) @ w[r]            # (g, g * m_s, n_local)

The schedules differ in how the all-gather is decomposed and interleaved
with the GEMM, and keep the reference's row arithmetic exactly:

  * ``serial_ag_matmul``  — one all-gather, one GEMM (paper Fig. 3b).
  * ``shard_p2p_matmul``  — AsyncTP-style ring: shards stream one link per
    step (``ppermute``), a GEMM per shard (Fig. 3c).
  * ``ficco_*``           — FiCCO: each shard is cut into ``g`` chunks;
    each step exchanges one chunk with every peer (a chunk-sized
    all-gather) and runs the configured chunk-granular GEMM (Fig. 11b).

Their GEMMs are plain ``torch.matmul``, as the reference's are ``jnp`` ``@``
outside any Pallas kernel, with one exception: ``ficco_uniform_fused_2d``
folds each step's product into its fp32 accumulator with K2
(:func:`repro_torch.kernels.ops.matmul_accumulate`), the accumulating GEMM
that the reference's kernel docstrings assign to this step.  The numbers
change only in that the step product is no longer rounded to the operands'
dtype before the fp32 add: for bf16 the port's sum is the closer one.

The collectives are :mod:`repro_torch.parallel.collectives`.  Output
buffers are ``torch.empty``: every schedule writes each row exactly once.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.schedule_types import Schedule
from repro_torch.kernels import ops
from repro_torch.parallel.collectives import all_gather, ppermute


def _out(x: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
    g, _, _ = x.shape
    return torch.empty(
        (g, rows, w.shape[-1]),
        dtype=torch.promote_types(x.dtype, w.dtype),
        device=x.device,
    )


def _chunk_rows(x: torch.Tensor, g: int) -> torch.Tensor:
    """(g, m_s, K) -> (g, g, m_c, K) row chunks: [rank, step]."""
    _, m_s, k = x.shape
    if m_s % g:
        raise ValueError(f"shard rows {m_s} not divisible by group {g}")
    return x.reshape(g, g, m_s // g, k)


def _remote_sources(g: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank r's remote peers in the hetero schedules' order.

    ``jnp.roll(gathered, -(me + 1), axis=0)[: g - 1]`` on rank ``me``:
    slot j holds peer (me + 1 + j) % g.  Returns (me, src), shapes (g, 1)
    and (g, g - 1), for indexing a stacked (g, g, ...) gathered buffer.
    """
    me = torch.arange(g, device=device)
    src = (me[:, None] + 1 + torch.arange(g - 1, device=device)[None]) % g
    return me[:, None], src


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def serial_ag_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Paper Fig. 3(b): all-gather the input shards, then one big GEMM."""
    x_full = all_gather(x, tiled=True)  # (g, M, K) on every rank
    return torch.matmul(x_full, w)


def shard_p2p_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Shard-granularity ring overlap (PyTorch AsyncTP, paper Fig. 3c).

    Each step sends the current shard to the right neighbour (``ppermute``
    — a single P2P link per step, the topology weakness FiCCO fixes) while
    computing the GEMM on the shard already held.
    """
    g, m_s, _ = x.shape
    out = _out(x, w, g * m_s)
    blocks = out.view(g, g, m_s, w.shape[-1])  # [rank, source shard]
    me = torch.arange(g, device=x.device)
    buf = x
    for step in range(g):
        src = (me - step) % g  # whose shard each rank currently holds
        blocks[me, src] = torch.matmul(buf, w)
        if step != g - 1:
            buf = ppermute(buf, 1)
    return out


# ---------------------------------------------------------------------------
# FiCCO schedules (paper Fig. 11b)
# ---------------------------------------------------------------------------

def ficco_uniform_fused_1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """uniform-fused-1D: g steps; step s exchanges chunk s with all peers
    (all-to-all shaped), gathers local+remote into one buffer, runs ONE
    identical (M/g, N_local, K) GEMM, and scatters the output rows."""
    g, m_s, k = x.shape
    n_local = w.shape[-1]
    m_c = m_s // g
    chunks = _chunk_rows(x, g)
    out = _out(x, w, g * m_s)
    # out[r, d * m_s + s * m_c + i] viewed as [r, d, s, i].
    out_steps = out.view(g, g, g, m_c, n_local)
    for s in range(g):
        gathered = all_gather(chunks[:, s])  # (g, g, m_c, K)
        step_buf = gathered.view(g, g * m_c, k)  # Gather
        step_out = torch.matmul(step_buf, w)  # identical GEMM every step
        # Scatter: row block from rank d lands at global row d*m_s + s*m_c.
        out_steps[:, :, s] = step_out.view(g, g, m_c, n_local)
    return out


def ficco_hetero_fused_1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """hetero-fused-1D: compute the whole local shard immediately (hiding
    the first exposed exchange), then per step one fused GEMM over the g-1
    *remote* chunks received in that step."""
    g, m_s, k = x.shape
    n_local = w.shape[-1]
    m_c = m_s // g
    out = _out(x, w, g * m_s)
    me, src = _remote_sources(g, x.device)
    # Step 0: local shard, no communication dependency.
    out.view(g, g, m_s, n_local)[me[:, 0], me[:, 0]] = torch.matmul(x, w)

    chunks = _chunk_rows(x, g)
    out_steps = out.view(g, g, g, m_c, n_local)  # [rank, src, step]
    for s in range(g):
        gathered = all_gather(chunks[:, s])  # (g, g, m_c, K)
        # Remote-only gather: slot j of rank r holds peer (r + 1 + j) % g.
        rolled = gathered[me, src]  # (g, g - 1, m_c, K)
        step_buf = rolled.view(g, (g - 1) * m_c, k)
        step_out = torch.matmul(step_buf, w)
        out_steps[me, src, s] = step_out.view(g, g - 1, m_c, n_local)
    return out


def ficco_hetero_unfused_1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """hetero-unfused-1D: like hetero-fused but one GEMM *per chunk* —
    no Gather at all, maximum scheduling freedom, highest DIL."""
    g, m_s, k = x.shape
    n_local = w.shape[-1]
    m_c = m_s // g
    out = _out(x, w, g * m_s)
    me, src = _remote_sources(g, x.device)
    out.view(g, g, m_s, n_local)[me[:, 0], me[:, 0]] = torch.matmul(x, w)
    chunks = _chunk_rows(x, g)
    out_steps = out.view(g, g, g, m_c, n_local)
    for s in range(g):
        gathered = all_gather(chunks[:, s])
        for j in range(g - 1):
            piece = torch.matmul(gathered[me[:, 0], src[:, j]], w)
            out_steps[me[:, 0], src[:, j], s] = piece  # unfused chunk GEMM
    return out


def ficco_uniform_fused_2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """uniform-fused-2D: chunks are K (column) slices; step s assembles the
    full-M (M, K/g) panel and runs the accumulating GEMM C += panel @
    w_slice (K2).  Output rows are contiguous — no Scatter; requires
    accumulation instead.  K2 records its update for autograd, so the
    result differentiates as the reference's ``jnp`` schedule does; the
    K slices are ``split`` views, whose backward is one concatenation.
    """
    g, m_s, k = x.shape
    n_local = w.shape[-1]
    if k % g:
        raise ValueError(f"K={k} not divisible by group {g}")
    k_c = k // g
    acc = torch.zeros(
        (g, g * m_s, n_local), dtype=torch.float32, device=x.device
    )
    # chunk s: (g, m_s, K/g); w_slice s: (g, K/g, n_local)
    for chunk, w_slice in zip(x.split(k_c, dim=2), w.split(k_c, dim=1)):
        panel = all_gather(chunk, tiled=True)  # (g, M, K/g): rows contiguous
        acc = ops.matmul_accumulate(acc, panel, w_slice)  # C += A_s @ B_s
    return acc.to(torch.promote_types(x.dtype, w.dtype))


SCHEDULE_FNS: dict[Schedule, Callable[..., torch.Tensor]] = {
    Schedule.SERIAL: serial_ag_matmul,
    Schedule.SHARD_P2P: shard_p2p_matmul,
    Schedule.UNIFORM_FUSED_1D: ficco_uniform_fused_1d,
    Schedule.HETERO_FUSED_1D: ficco_hetero_fused_1d,
    Schedule.HETERO_UNFUSED_1D: ficco_hetero_unfused_1d,
    Schedule.UNIFORM_FUSED_2D: ficco_uniform_fused_2d,
}


def run_schedule(
    schedule: Schedule, x: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    return SCHEDULE_FNS[schedule](x, w)


__all__ = [
    "SCHEDULE_FNS",
    "run_schedule",
    "serial_ag_matmul",
    "shard_p2p_matmul",
    "ficco_uniform_fused_1d",
    "ficco_hetero_fused_1d",
    "ficco_hetero_unfused_1d",
    "ficco_uniform_fused_2d",
]
