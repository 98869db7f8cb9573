"""Plain PyTorch versions of the kernels, over the stacked-rank layout.

They are the kernels' CPU path and the oracles the kernels are held
against on the card.  A tensor sharded over ``g`` logical ranks carries
the rank on its leading dim (see :mod:`repro_torch.parallel.sharding`).
"""

from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``chunked_matmul``: fp32 product cast to x.dtype.

    x: (M, K) or (g, M, K); w: (K, N) or (g, K, N).
    """
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def a2a_chunk_exchange_ref(
    chunks: torch.Tensor,
    *,
    reverse: bool = False,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of ``a2a_chunk_exchange``: the all-gather of the chunks.

    chunks: (g, m_c, K), rank r's chunk at [r] -> (g, g, m_c, K), where
    out[r, s] is rank s's chunk in rank r's step buffer.  One slice copy
    per (sender, slot) pair, in the kernel's issue order.
    """
    g = chunks.shape[0]
    if out is None:
        out = torch.empty(
            (g, *chunks.shape), dtype=chunks.dtype, device=chunks.device
        )
    for me in range(g):
        out[me, me].copy_(chunks[me])
        for i in range(1, g):
            peer = (me + (g - i if reverse else i)) % g
            out[peer, me].copy_(chunks[me])
    return out


def ag_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Oracle for ``ficco_uniform_fused_1d_dma``: all-gather, then one GEMM.

    x: (g, m_s, K) row shards; w: (g, K, n_local) column shards ->
    (g, g * m_s, n_local), rank r's block of the full product.
    """
    g, m_s, k = x.shape
    return torch.matmul(x.reshape(g * m_s, k), w)


__all__ = ["matmul_ref", "a2a_chunk_exchange_ref", "ag_matmul_ref"]
