"""Shared neural layers: norms, RoPE, GQA attention, MLPs.

Port of ``repro.models.layers``.  Layers are plain tensor
functions over parameter dicts, with the reference's layouts: activations
(B, S, d), attention heads (B, S, H, D), weights (in, out).  Norms, RoPE,
attention scores and softmax compute in fp32 as the reference does, and
cast back to the activation dtype.  Attention and the dense projections
are plain PyTorch ops, as the reference leaves them to XLA; the TP MLP's
up and gate projections take the FiCCO path (``repro_torch.parallel.tp``)
when an overlap context and a tensor-parallel group are active.

On a rank of a group of processes (a ``RankGroup``) the params hold the
rank's blocks (``repro_torch.parallel.sharding.shard_params``): the
attention's Q/K/V column blocks and ``wo``'s row block, the MLP's column
and row blocks.  Each rank computes its part, as GSPMD partitions the
reference's ``constrain``ed heads, and the group sums the partial output
projections.  With ``seq=True`` the input is the rank's (B, S/g, d)
block of the residual stream, cut by sequence as the reference's
``constrain(x, BATCH_AXES, MODEL_AXIS, None)`` cuts it (Megatron's
sequence parallelism): the layer all-gathers it along the sequence and
reduce-scatters its output back to the rank's block
(:func:`~repro_torch.parallel.collectives.psum_scatter`).  Otherwise the
input is replicated and one ``all_reduce`` sums the output.  Between the
two collectives a rank computes only its part: the cotangents there are
the rank's partial ones, so a gather of the ranks' blocks is an
``all_gather`` (its transpose sums them), a whole weight is marked
``replicated`` (its gradient summed over the ranks), and a rank takes its
part of a tensor every rank holds by a plain slice.
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
    seq: bool = False,
) -> torch.Tensor:
    """Training/prefill attention.  x: (B, S, d); with ``seq``, on a
    ``RankGroup``, the rank's (B, S/g, d) block, ``positions`` the whole
    sequence's.

    Self-attention with RoPE: causal in a decoder, bidirectional with
    ``causal=False`` (the encoder's, as the reference's ``_layer_apply``
    writes it).  With ``kv_for_cross`` (B, S_enc, d), the keys and values
    come from the encoder's output: cross-attention, no RoPE, no mask.  On
    a rank it is whole and already the rank's operand for a partial
    computation (``Model._encode``: an all-gather's output or marked
    ``replicated``), so it is not marked here.
    """
    group = rank_group()
    if group is not None:
        return _attn_apply_rank(params, x, dims, group, rope_theta=rope_theta,
                                positions=positions, window=window,
                                causal=causal, kv_for_cross=kv_for_cross,
                                seq=seq)
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
    """One-token decode. x: (B, 1, d); cache: {"k","v"} (B, S, KV, D),
    and ``"time_slice"`` where it holds a rank's slice of the time axis.

    The cache is updated in place (the reference returns a new one); the
    same dict is returned.
    """
    group = rank_group()
    if group is not None:
        return _attn_decode_rank(params, x, cache, pos, dims, group,
                                 rope_theta=rope_theta, window=window)
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

        if decode_attn.applicable(cache["k"], window,
                                  time_slice="time_slice" in cache):
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
# GQA attention on a rank of a group of processes
# ---------------------------------------------------------------------------

def rank_group():
    """The active group where it is a ``RankGroup`` of more than one rank,
    else None."""
    from repro_torch.parallel.group import RankGroup
    from repro_torch.parallel.sharding import active_group

    group = active_group()
    return group if isinstance(group, RankGroup) and group.size > 1 else None


def _cut(w: torch.Tensor, n: int, dim: int) -> bool:
    """Whether the rank holds a block of ``w`` (n wide on ``dim`` whole)."""
    return w.shape[dim] != n


def _heads_mine(dims: AttnDims, g: int) -> bool:
    """Whether each rank computes its own h/g query and kv/g K/V heads:
    where g divides both, as the reference's ``constrain`` keeps both
    shardings.  Otherwise every rank computes every head (the same
    output; the reference keeps Q's sharding where only h divides)."""
    return dims.num_heads % g == 0 and dims.num_kv_heads % g == 0


def rank_input(x, group, seq: bool):
    """A layer's input on a rank, for the rank's partial computation: the
    rank's sequence block gathered along the sequence (``seq``; the
    gather's transpose sums the ranks' partial cotangents and keeps the
    rank's block), or the replicated ``x`` marked ``replicated`` (its
    gradient the sum of the ranks' parts)."""
    from repro_torch.parallel.collectives import all_gather, replicated

    if seq:
        return all_gather(x, tiled=True, axis=1, group=group)
    return replicated(x, group=group)


def rank_output(y, group, seq: bool):
    """The group's sum of the ranks' partial outputs ``y`` (B, S, d): the
    rank's sequence block of it (``seq``, a reduce-scatter), or all of it
    on every rank (an ``all_reduce``)."""
    from repro_torch.parallel.collectives import all_reduce, psum_scatter

    if seq:
        return psum_scatter(y, 1, group=group)
    return all_reduce(y, group=group)


def rank_channels(width: int, group) -> tuple[int, int]:
    """A rank's (first, count) of a recurrent mixer's ``width`` (d_inner)
    channels: its block, as the reference's specs cut them.  Raises
    where the group does not divide them (the rule would keep every
    leaf whole, which no per-rank mixer computes)."""
    if width % group.size:
        raise ValueError(
            f"a recurrent mixer of d_inner {width} on a RankGroup of "
            f"{group.size}: the per-rank mixer needs the group to divide it")
    n = width // group.size
    return group.rank * n, n


def rank_halves(inp, w, width: int, group):
    """``inp @ w`` split into its halves u and z of ``width`` columns
    each (a recurrent mixer's input projection, ``[u | z]``), whole, on a
    rank that holds ``w``'s column block of the 2 * ``width`` columns:
    a block of the concatenation, not the rank's share of each half, so
    the blocks' products are all-gathered (its transpose, a
    reduce-scatter, sums the ranks' partial cotangents) and the rank
    takes what it needs of both halves by plain slices."""
    from repro_torch.parallel.collectives import all_gather

    return all_gather(inp @ w, tiled=True, axis=-1, group=group).split(
        width, dim=-1)


def _share(width: int, g: int, r: int) -> tuple[int, int]:
    """Rank r's (first, count) of ``width`` items split g ways, the larger
    shares first (``torch.tensor_split``'s)."""
    base, extra = divmod(width, g)
    return r * base + min(r, extra), base + (r < extra)


def _rank_heads(inp, w, n: int, hd: int, group, *, mine: bool):
    """``inp @ w`` as (B, S, heads, hd) on this rank, ``inp`` the layer's
    input (:func:`rank_input`): its n/g heads where ``mine`` (``w`` is
    their column block), else all n, the column blocks gathered by an
    ``all_gather``; a whole ``w`` (marked ``replicated``) gives all n at
    once."""
    from repro_torch.parallel.collectives import all_gather, replicated

    b, s = inp.shape[:2]
    if not _cut(w, n * hd, -1):
        return (inp @ replicated(w, group=group)).view(b, s, n, hd)
    t = inp @ w
    if not mine:
        t = all_gather(t, tiled=True, axis=-1, group=group)
    return t.view(b, s, -1, hd)


def _rank_part(out, wo, width: int, group):
    """This rank's part of ``out`` (B, S, heads * hd) times ``wo``
    (``width`` rows whole): ``wo``'s row block against the same columns
    of ``out``, or, where ``wo`` is whole, the rank's share of its rows.
    The group's sum of the parts is the product."""
    from repro_torch.parallel.collectives import replicated

    if _cut(wo, width, 0):
        first, rows = group.rank * wo.shape[0], wo.shape[0]
    else:
        first, rows = _share(width, group.size, group.rank)
        wo = replicated(wo, group=group).narrow(0, first, rows)
    if out.shape[-1] != rows:  # out holds every head
        out = out.narrow(-1, first, rows)
    return out @ wo


def _attn_apply_rank(params, x, dims: AttnDims, group, *, rope_theta,
                     positions, window, causal, kv_for_cross, seq):
    """:func:`attn_apply` on a rank holding its blocks.

    Where g divides the query and the K/V heads the rank computes its
    h/g and kv/g heads, whose output block meets ``wo``'s row block.
    Where it does not (SmolLM's 15 / 5 on 4), the rank gathers its Q/K/V
    column blocks to whole heads, computes every head, and multiplies by
    ``wo``'s row block only the columns that block owns.  The group sums
    the partial products (:func:`rank_output`).  A cross-attention's
    ``kv_for_cross`` is used as it comes (:func:`attn_apply`): marking an
    all-gather's output ``replicated`` as well would sum the ranks'
    cotangents twice, g times the gradient.
    """
    b = x.shape[0]
    h, kv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    mine = _heads_mine(dims, group.size)
    x_in = rank_input(x, group, seq)
    s = x_in.shape[1]
    src = x_in if kv_for_cross is None else kv_for_cross
    q = _rank_heads(x_in, params["wq"], h, hd, group, mine=mine)
    k, v = (_rank_heads(src, params[key], kv, hd, group, mine=mine)
            for key in ("wk", "wv"))
    if kv_for_cross is None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
        out = blockwise_attention(q, k, v, causal=causal, window=window)
    else:
        out = blockwise_attention(q, k, v, causal=False)
    return rank_output(_rank_part(out.reshape(b, s, -1), params["wo"],
                                  h * hd, group), group, seq)


def _attn_decode_rank(params, x, cache, pos: int, dims: AttnDims, group, *,
                      rope_theta, window):
    """:func:`attn_decode` on a rank holding its blocks.  The cache holds
    every K/V head, whole or, where the reference's rule cuts its time
    axis (``"time_slice"``), the rank's slice, so the new token's K and V
    columns, and its Q columns where the time-sliced body or indivisible
    heads need every query head, are gathered in one all-gather of their
    concatenation.  The rank whose slice holds the position writes it.
    With ``decode_attn="shard_map"`` a time slice takes the reference's
    flash-decode body; otherwise the rank attends over the whole cache, as
    GSPMD partitions the chain op by op: every rank's slice gathered (an
    all-gather where it computes every head, an all-to-all of the slices
    of each rank's own kv/g heads where it computes those).  The group
    sums the partial output products."""
    from repro_torch.parallel import decode_attn
    from repro_torch.parallel.collectives import (all_gather, all_reduce,
                                                  all_to_all)
    from repro_torch.parallel.context import get_overlap

    g, r = group.size, group.rank
    b = x.shape[0]
    h, kv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    ov = get_overlap()
    sliced = "time_slice" in cache
    flash = (sliced and ov is not None and ov.decode_attn == "shard_map"
             and decode_attn.applicable(cache["k"], window, time_slice=True))
    q_all = flash or not _heads_mine(dims, g)
    proj = {"q": (params["wq"], h), "k": (params["wk"], kv),
            "v": (params["wv"], kv)}
    cols = {key: x @ w for key, (w, _) in proj.items()}
    gather = [key for key, (w, n) in proj.items()
              if _cut(w, n * hd, -1) and (key != "q" or q_all)]
    if gather:
        joined = all_gather(torch.cat([cols[key] for key in gather], -1),
                            group=group)
        parts = joined.split([cols[key].shape[-1] for key in gather], -1)
        for key, part in zip(gather, parts):
            cols[key] = part.movedim(0, -2).flatten(-2)
    q, k, v = (cols[key].view(b, 1, -1, hd) for key in ("q", "k", "v"))
    posv = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, posv, rope_theta)
    k = apply_rope(k, posv, rope_theta)
    if flash:
        out, cache["k"], cache["v"] = decode_attn.shard_map_attn_decode(
            q, k, v, cache["k"], cache["v"], pos)
    else:
        s_here = cache["k"].shape[1]
        s_all = s_here * g if sliced else s_here
        slot = pos % s_all if window is not None else pos
        first = r * s_here if sliced else 0
        if first <= slot < first + s_here:
            cache["k"][:, slot - first] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, slot - first] = v[:, 0].to(cache["v"].dtype)
        k_c, v_c = cache["k"], cache["v"]
        if sliced:  # every rank's slice of the heads this rank computes
            kv_c = torch.cat([k_c, v_c], -1)
            if q_all:
                kv_c = all_gather(kv_c, tiled=True, axis=1, group=group)
            else:  # slice s of rank r's heads goes from rank s to rank r
                kv_c = all_to_all(kv_c.unflatten(2, (g, -1)).movedim(2, 0),
                                  group=group).movedim(0, 1).flatten(1, 2)
            k_c, v_c = kv_c.chunk(2, -1)
        elif not q_all:  # the rank's kv/g heads, read in place
            n = kv // g
            k_c, v_c = (t[:, :, r * n:(r + 1) * n] for t in (k_c, v_c))
        out = cache_attention(q, k_c, v_c, valid_len=pos + 1,
                              ring=window is not None)
    return (all_reduce(_rank_part(out.reshape(b, 1, -1), params["wo"],
                                  h * hd, group), group=group), cache)


def cross_attn_decode(params, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, dims: AttnDims, *,
                      sliced: bool = False) -> torch.Tensor:
    """One token's cross-attention over an encoder-decoder's cached K and
    V (B, S_enc, KV, D), every position valid: x (B, 1, d) -> (B, 1, d),
    no RoPE.

    On a ``RankGroup`` the params are the rank's blocks and the cache its
    block by the reference's rule: every K/V head, whole or (``sliced``)
    the rank's slice of the encoder's time.  Over a whole cache the rank
    attends with its h/g query heads (every head, their column blocks
    gathered, where g does not divide h) against the K/V heads they read;
    over a time slice every rank attends with every query head over its
    slice and the group combines the partial softmaxes
    (:func:`~repro_torch.parallel.decode_attn.slice_attention`).  Then the
    rank's part of the product with ``wo`` (its row block) and one
    ``all_reduce``."""
    group = rank_group()
    b = x.shape[0]
    h, hd = dims.num_heads, dims.head_dim
    if group is None:
        q = (x @ params["wq"]).view(b, 1, h, hd)
        out = cache_attention(q, k_cache, v_cache,
                              valid_len=k_cache.shape[1], ring=True)
        return out.reshape(b, 1, h * hd) @ params["wo"]
    from repro_torch.parallel import decode_attn
    from repro_torch.parallel.collectives import all_reduce

    q = _rank_heads(x, params["wq"], h, hd, group,
                    mine=not sliced and h % group.size == 0)
    n = q.shape[2]
    if sliced:
        out = decode_attn.slice_attention(q, k_cache, v_cache, group=group)
    else:  # the K/V heads that the rank's n query heads read
        first = group.rank * n if n < h else 0
        idx = torch.arange(first, first + n, device=x.device) // (
            h // dims.num_kv_heads)
        out = cache_attention(q, k_cache[:, :, idx], v_cache[:, :, idx],
                              valid_len=k_cache.shape[1], ring=True)
    return all_reduce(_rank_part(out.reshape(b, 1, -1), params["wo"],
                                 h * hd, group), group=group)


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


def mlp_apply(params, x: torch.Tensor, ff: int | None = None, *,
              seq: bool = False) -> torch.Tensor:
    """TP MLP.  The up/gate projections are the paper's data-dependent
    AG->GEMM pair: with an overlap context and a TP group active they run
    a FiCCO schedule (repro_torch.parallel.tp); otherwise dense.  The down
    projection stays a plain product (the paper omits reduction-fused
    scenarios: DMA engines lack arithmetic, §IV-B2).

    Under a group of processes (a ``RankGroup``) the params hold this
    rank's blocks (``repro_torch.parallel.sharding.shard_params``):
    the rank computes ``silu(x @ w_gate_r) * (x @ w_up_r) @ w_down_r`` and
    the group sums the partial products, as GSPMD does for the
    reference's ``constrain``ed down projection.  With ``seq`` x is the
    rank's (B, S/g, d) sequence block, the FiCCO site's own rows, and the
    output the rank's block of the sum.  ``ff``, the hidden width whole,
    tells a rank's blocks from whole weights (the group does not divide
    it); a rank needs it."""
    from repro_torch.parallel.context import get_overlap
    from repro_torch.parallel.group import RankGroup
    from repro_torch.parallel.sharding import active_group

    ov = get_overlap()
    group = active_group()
    if isinstance(group, RankGroup):
        return _mlp_apply_rank(params, x, ff, ov, group, seq)
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


def _mlp_apply_rank(params, x, ff, ov, group, seq: bool) -> torch.Tensor:
    """:func:`mlp_apply` on one rank of a group of processes.  With
    ``seq`` and an overlap mode the up and gate projections are FiCCO
    linears on the rank's sequence block (their schedules' all-gathers
    transpose to reduce-scatters); otherwise the input is gathered or
    marked once (:func:`rank_input`).  Where the weights are whole (g
    does not divide ``ff``) the rank takes its share of the hidden
    columns and of ``w_down``'s rows, the weights marked ``replicated``,
    as :func:`_rank_part` shares a whole ``wo``.  The down projection's
    partial products are summed by :func:`rank_output`, whose transpose
    hands every rank the whole cotangent."""
    from repro_torch.parallel import tp
    from repro_torch.parallel.collectives import replicated

    if ff is None:
        raise ValueError("an MLP on a rank needs its whole hidden width ff")
    whole = not _cut(params["w_up"], ff, -1)
    w_up, w_gate, w_down = (params["w_up"], params.get("w_gate"),
                            params["w_down"])
    if whole:
        first, cols = _share(ff, group.size, group.rank)
        w_up, w_down = (replicated(w_up, group=group).narrow(1, first, cols),
                        replicated(w_down, group=group).narrow(0, first,
                                                               cols))
        if w_gate is not None:
            w_gate = replicated(w_gate, group=group).narrow(1, first, cols)
    ficco = seq and not whole and ov is not None and ov.mode != "gspmd_serial"
    x_in = None if ficco else rank_input(x, group, seq)

    def up(w):
        if ficco:
            return tp.tp_ficco_linear(x, w, ov)
        return x_in @ w

    h = up(w_up)
    if w_gate is not None:
        h = F.silu(up(w_gate)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return rank_output(h @ w_down, group, seq)
