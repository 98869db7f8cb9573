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


def accumulate_matmul_ref(
    c: torch.Tensor, x: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Plain version of ``accumulate_matmul``: C += x @ w in fp32, in place.

    c: (M, N) or (g, M, N); the fp32 sum is cast to c.dtype and stored
    back into c, which is returned (the TPU kernel aliases C's input and
    output buffers).
    """
    return c.copy_(c.float() + torch.matmul(x.float(), w.float()))


def a2a_chunk_exchange_ref(chunks, *, reverse: bool = False, out=None):
    """Plain version of ``a2a_chunk_exchange``: the all-gather of the chunks.

    chunks: (g, m_c, K), rank r's chunk at [r] -> (g, g, m_c, K), where
    out[r][s] is rank s's chunk in rank r's step buffer.  Either may be a
    sequence of per-rank tensors instead.  One slice copy per (sender,
    slot) pair, in the pairs route's issue order.
    """
    g = len(chunks)
    if out is None:
        out = torch.empty(
            (g, g, *chunks[0].shape), dtype=chunks[0].dtype,
            device=chunks[0].device,
        )
    for me in range(g):
        out[me][me].copy_(chunks[me])
        for i in range(1, g):
            peer = (me + (g - i if reverse else i)) % g
            out[peer][me].copy_(chunks[me])
    return out


def ag_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``ficco_ag_matmul_fused`` and oracle for
    ``ficco_uniform_fused_1d_dma``: all-gather, then one GEMM.

    x: (g, m_s, K) row shards; w: (g, K, n_local) column shards ->
    (g, g * m_s, n_local), rank r's block of the full product.
    """
    g, m_s, k = x.shape
    return torch.matmul(x.reshape(g * m_s, k), w)


__all__ = [
    "matmul_ref",
    "accumulate_matmul_ref",
    "a2a_chunk_exchange_ref",
    "ag_matmul_ref",
]
