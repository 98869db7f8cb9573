"""Shared neural layers: norms, RoPE, GQA attention, MLPs.

Port of ``repro.models.layers``.  Layers are plain tensor
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

from repro_torch.parallel.sharding import MODEL_AXIS, P

_NEG_INF = -1e30


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    std = 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=device)
    return (w * std).to(dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) + log1p(exp(
    -|x|)), with no switch to the identity at large x (as
    ``torch.nn.functional.softplus`` has)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


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

def _block_attn(q, k, v, mask):
    """One (query block, key block) pair of the online softmax.

    q: (B, bq, H, Dk); k: (B, bk, KV, Dk); v: (B, bk, KV, Dv), where Dv
    may be narrower than Dk (MLA); the scale is 1/sqrt(Dk).  mask:
    broadcastable to (bq, bk), or None where the block masks nothing.
    GQA repeats K and V to the heads over this key block only.  Returns
    the block's row max m and row sum l (B, H, bq) and unnormalised output
    o (B, bq, H, Dv), all fp32.  The result does not depend on the max (it cancels between o
    and l), so m is detached: no gradient flows through it, as none flows
    through the max inside ``torch.softmax``.
    """
    d = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    kr = k.repeat_interleave(rep, dim=2).float()
    vr = v.repeat_interleave(rep, dim=2).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / math.sqrt(d)
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_INF)
    m = scores.detach().amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bhqk,bkhd->bqhd", p, vr)


def _and(mask, term):
    return term if mask is None else mask & term


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Exact attention over query blocks x key blocks with an online
    softmax (memory O(block_q * block_k) per head), as the reference's.

    q: (B, Sq, H, Dk); k: (B, Sk, KV, Dk); v: (B, Sk, KV, Dv) -> (B, Sq,
    H, Dv).  ``q_offset`` is the absolute position of q[0] relative to
    k[0].  Both sequences are padded to block
    multiples and the padding masked; the running max, sum and output merge
    in fp32, and the result is cast to q's dtype.  The first key block
    starts the running state, which is what the reference's merge into an
    empty state (max -1e30, sums 0) gives exactly.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    pq, pk = (-sq) % block_q, (-sk) % block_k
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    q_base = torch.arange(block_q, device=q.device)
    k_base = torch.arange(block_k, device=q.device)
    outs = []
    for q0 in range(0, sq + pq, block_q):
        q_pos = q_offset + q0 + q_base
        for k0 in range(0, sk + pk, block_k):
            k_pos = k0 + k_base
            mask = None
            if k0 + block_k > sk:  # padded keys
                mask = _and(mask, (k_pos < sk)[None, :])
            if q0 + block_q > sq:  # padded queries
                mask = _and(mask, (q_pos < q_offset + sq)[:, None])
            if causal:
                mask = _and(mask, q_pos[:, None] >= k_pos[None, :])
            if window is not None:
                mask = _and(mask, q_pos[:, None] - k_pos[None, :] < window)
            m_b, l_b, o_b = _block_attn(
                q[:, q0:q0 + block_q], k[:, k0:k0 + block_k],
                v[:, k0:k0 + block_k], mask,
            )
            if k0 == 0:
                m_run, l_run, o_run = m_b, l_b, o_b
                continue
            m_new = torch.maximum(m_run, m_b)
            a1 = torch.exp(m_run - m_new)
            a2 = torch.exp(m_b - m_new)
            l_run = l_run * a1 + l_b * a2
            o_run = (o_run * a1.transpose(1, 2)[..., None]
                     + o_b * a2.transpose(1, 2)[..., None])
            m_run = m_new
        outs.append(o_run / l_run.clamp_min(1e-30).transpose(1, 2)[..., None])
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def cache_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: int,
    *,
    ring: bool = False,
) -> torch.Tensor:
    """Single-token decode attention over a (B, S, KV, Dk) key cache and
    a (B, S, KV, Dv) value cache -> (B, 1, H, Dv), scaled by 1/sqrt(Dk).

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


def attn_param_specs():
    """Column-parallel Q/K/V and a row-parallel output projection."""
    return {
        "wq": P(None, MODEL_AXIS),
        "wk": P(None, MODEL_AXIS),
        "wv": P(None, MODEL_AXIS),
        "wo": P(MODEL_AXIS, None),
    }


def attn_apply(
    params,
    x: torch.Tensor,
    dims: AttnDims,
    *,
    rope_theta: float,
    positions: torch.Tensor,
    window: Optional[int] = None,
    causal: bool = True,
    kv_for_cross: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Training/prefill attention.  x: (B, S, d).

    Self-attention with RoPE: causal in a decoder, bidirectional with
    ``causal=False`` (the encoder's, as the reference's ``_layer_apply``
    writes it).  With ``kv_for_cross`` (B, S_enc, d), the keys and values
    come from the encoder's output: cross-attention, no RoPE, no mask.
    """
    b, s, _ = x.shape
    h, kv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    src = kv_for_cross if kv_for_cross is not None else x
    q = (x @ params["wq"]).view(b, s, h, hd)
    k = (src @ params["wk"]).view(b, src.shape[1], kv, hd)
    v = (src @ params["wv"]).view(b, src.shape[1], kv, hd)
    if kv_for_cross is None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
        out = blockwise_attention(q, k, v, causal=causal, window=window)
    else:
        out = blockwise_attention(q, k, v, causal=False)
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
        from repro_torch.parallel import decode_attn

        if decode_attn.applicable(cache["k"], window):
            out, cache["k"], cache["v"] = decode_attn.shard_map_attn_decode(
                q, k, v, cache["k"], cache["v"], pos
            )
            return out.reshape(b, 1, h * hd) @ params["wo"], cache
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


def mlp_param_specs(*, gated: bool = True):
    p = {"w_up": P(None, MODEL_AXIS), "w_down": P(MODEL_AXIS, None)}
    if gated:
        p["w_gate"] = P(None, MODEL_AXIS)
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
