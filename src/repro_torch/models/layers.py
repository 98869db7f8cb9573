"""Shared neural layers: norms, RoPE, GQA attention, MLPs.

Port of ``repro.models.layers`` (dense parts).  Layers are plain tensor
functions over parameter dicts, with the reference's layouts: activations
(B, S, d), attention heads (B, S, H, D), weights (in, out).  Norms, RoPE,
attention scores and softmax compute in fp32 as the reference does, and
cast back to the activation dtype.  Attention and the dense projections
are plain PyTorch ops, as the reference leaves them to XLA; the TP MLP's
up and gate projections take the FiCCO path (``repro_torch.parallel.tp``)
when an overlap context and a tensor-parallel group are active.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    std = 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=device)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str, dtype, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {
            "scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device),
        }
    if kind == "nonparametric_ln":  # OLMo: no affine parameters
        return {}
    raise ValueError(kind)


def apply_norm(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        return (y * params["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated by halves; positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    block_q: int = 512,
) -> torch.Tensor:
    """Exact attention, one block of queries at a time (memory O(bq * Sk)).

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D).  ``q_offset`` is the absolute
    position of q[0] relative to k[0].  Scores and softmax are fp32; the
    result is cast to q's dtype (the reference's online softmax over KV
    blocks computes the same function).
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    kr = k.repeat_interleave(rep, dim=2).float()  # (B, Sk, H, D)
    vr = v.repeat_interleave(rep, dim=2).float()
    k_pos = torch.arange(sk, device=q.device)
    outs = []
    for q0 in range(0, sq, block_q):
        qb = q[:, q0:q0 + block_q].float()
        scores = torch.einsum("bqhd,bkhd->bhqk", qb, kr) / math.sqrt(d)
        q_pos = q_offset + q0 + torch.arange(qb.shape[1], device=q.device)
        mask = torch.ones((qb.shape[1], sk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        scores = scores.masked_fill(~mask, _NEG_INF)
        p = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, vr))
    return torch.cat(outs, dim=1).to(q.dtype)


def cache_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: int,
    *,
    ring: bool = False,
) -> torch.Tensor:
    """Single-token decode attention over a (B, S, KV, D) cache.

    ``valid_len`` - number of valid cache entries.  With ``ring`` the whole
    buffer is valid (sliding-window ring cache, already full).
    """
    b, one, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    rep = h // kv
    kr = k_cache.repeat_interleave(rep, dim=2).float()
    vr = v_cache.repeat_interleave(rep, dim=2).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / math.sqrt(d)
    if not ring:
        valid = torch.arange(s, device=q.device) < valid_len
        scores = scores.masked_fill(~valid, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    return out.to(q.dtype)


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int


def attn_init(gen, dims: AttnDims, dtype, device):
    h, kv, hd, d = (
        dims.num_heads, dims.num_kv_heads, dims.head_dim, dims.d_model
    )
    return {
        "wq": dense_init(gen, d, h * hd, dtype, device),
        "wk": dense_init(gen, d, kv * hd, dtype, device),
        "wv": dense_init(gen, d, kv * hd, dtype, device),
        "wo": dense_init(gen, h * hd, d, dtype, device),
    }


def attn_apply(
    params,
    x: torch.Tensor,
    dims: AttnDims,
    *,
    rope_theta: float,
    positions: torch.Tensor,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Prefill attention (causal self-attention).  x: (B, S, d)."""
    b, s, _ = x.shape
    h, kv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    q = (x @ params["wq"]).view(b, s, h, hd)
    k = (x @ params["wk"]).view(b, s, kv, hd)
    v = (x @ params["wv"]).view(b, s, kv, hd)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    out = blockwise_attention(q, k, v, causal=True, window=window)
    return out.reshape(b, s, h * hd) @ params["wo"]


def attn_decode(
    params,
    x: torch.Tensor,
    cache: dict,
    pos: int,
    dims: AttnDims,
    *,
    rope_theta: float,
    window: Optional[int] = None,
):
    """One-token decode. x: (B, 1, d); cache: {"k","v"} (B, S, KV, D).

    The cache is updated in place (the reference returns a new one); the
    same dict is returned.
    """
    b = x.shape[0]
    h, kv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    q = (x @ params["wq"]).view(b, 1, h, hd)
    k = (x @ params["wk"]).view(b, 1, kv, hd)
    v = (x @ params["wv"]).view(b, 1, kv, hd)
    posv = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, posv, rope_theta)
    k = apply_rope(k, posv, rope_theta)

    from repro_torch.parallel.context import get_overlap

    ov = get_overlap()
    if ov is not None and ov.decode_attn == "shard_map":
        raise NotImplementedError(
            "decode_attn='shard_map' (parallel/decode_attn.py) is not ported "
            "yet (ROADMAP queue A, item 7: the other model families)"
        )
    s_cache = cache["k"].shape[1]
    slot = pos % s_cache if window is not None else pos
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    out = cache_attention(
        q, cache["k"], cache["v"], valid_len=pos + 1, ring=window is not None
    )
    return out.reshape(b, 1, h * hd) @ params["wo"], cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, ff: int, dtype, device, *, gated: bool = True):
    p = {
        "w_up": dense_init(gen, d, ff, dtype, device),
        "w_down": dense_init(gen, ff, d, dtype, device),
    }
    if gated:
        p["w_gate"] = dense_init(gen, d, ff, dtype, device)
    return p


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """TP MLP.  The up/gate projections are the paper's data-dependent
    AG->GEMM pair: with an overlap context and a TP group active they run
    a FiCCO schedule (repro_torch.parallel.tp); otherwise dense.  The down
    projection stays a plain product (the paper omits reduction-fused
    scenarios: DMA engines lack arithmetic, §IV-B2)."""
    from repro_torch.parallel.context import get_overlap

    ov = get_overlap()
    if ov is not None and ov.mode != "gspmd_serial":
        from repro_torch.parallel import tp

        if tp.overlap_applicable(x, params["w_up"]):
            h = tp.tp_ficco_linear(x, params["w_up"], ov)
            if "w_gate" in params:
                g = tp.tp_ficco_linear(x, params["w_gate"], ov)
                h = F.silu(g) * h
            else:
                h = F.gelu(h, approximate="tanh")
            return h @ params["w_down"]

    h = x @ params["w_up"]
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ params["w_down"]
