"""Distributed decode attention: flash-decode over a time-sharded cache.

Port of ``repro.parallel.decode_attn``.  With the KV cache time-sharded
over the tensor-parallel group, partitioning the scores -> softmax -> AV
chain op by op gathers every rank's K/V slices each decode step.  The
fix is the same move FiCCO makes for GEMMs: take the data-dependent
pattern out of the implicit partitioner and express it explicitly.

Each rank holds a contiguous time slice of the cache, performs the
in-place cache update if ``pos`` lands in its slice, computes *partial*
attention with its local max and denominator, and the group combines
with one tiny max and two sums of (B, H)-sized statistics:

    m   = max_g(m_loc)
    l   = sum_g(l_loc * exp(m_loc - m))
    out = sum_g(o_loc * exp(m_loc - m)) / l

Collectives per layer drop from O(B * S * KV * hd) gathered bytes to
O(B * H * hd).

The reference runs the body under ``shard_map`` on the ``model`` mesh
axis, with ``lax.pmax``/``lax.psum`` across devices.  The port's
:class:`~repro_torch.parallel.sharding.TPGroup` holds its ranks on one
device, so the cache is viewed as ``(B, g, S/g, KV, D)`` (rank r's time
slice at ``[:, r]``, no copy) and the collectives are a max and sums
over that rank dim, as :mod:`repro_torch.parallel.collectives` does it.
The reference computes with ``jnp`` einsums and XLA collectives, not
Pallas, so plain PyTorch ops are its faithful port.  The group has no
batch axis (the reference's ``BATCH_AXES``), so the batch always
divides.
"""

from __future__ import annotations

import math

import torch

from repro_torch.parallel.sharding import active_group

_NEG_INF = -1e30


def applicable(k_cache: torch.Tensor, window) -> bool:
    """The reference's guard: a group of more than one rank, no sliding
    window, the cache length a multiple of the group and at least 1024."""
    group = active_group()
    if group is None:
        return False
    g = group.size
    return (
        g > 1
        and window is None
        and k_cache.shape[1] % g == 0
        and k_cache.shape[1] >= 1024
    )


def shard_map_attn_decode(
    q: torch.Tensor,  # (B, 1, H, D) — post-RoPE
    k_new: torch.Tensor,  # (B, 1, KV, D) — post-RoPE
    v_new: torch.Tensor,  # (B, 1, KV, D)
    k_cache: torch.Tensor,  # (B, S, KV, D), time-sharded over the group
    v_cache: torch.Tensor,
    pos: int,
):
    """Returns (out (B, 1, H, D), k_cache, v_cache).

    The caches are updated in place (the reference returns new ones), as
    the port's unsharded ``attn_decode`` does.
    """
    g = active_group().size
    b, s, kv, d = k_cache.shape
    h = q.shape[2]
    s_loc = s // g
    k_c = k_cache.view(b, g, s_loc, kv, d)
    v_c = v_cache.view(b, g, s_loc, kv, d)
    # The masked write lands on one rank's slice only: that rank writes
    # in place, no other rank's slice changes.
    k_c[:, pos // s_loc, pos % s_loc] = k_new[:, 0].to(k_c.dtype)
    v_c[:, pos // s_loc, pos % s_loc] = v_new[:, 0].to(v_c.dtype)

    rep = h // kv
    kr = k_c.repeat_interleave(rep, dim=3).float()  # (B, g, s_loc, H, D)
    vr = v_c.repeat_interleave(rep, dim=3).float()
    scores = torch.einsum("bqhd,bgkhd->bghqk", q.float(), kr) / math.sqrt(d)
    offset = torch.arange(g, device=q.device)[:, None] * s_loc
    local_idx = torch.arange(s_loc, device=q.device)[None, :]
    valid = (local_idx + offset <= pos)[None, :, None, None, :]
    scores = scores.masked_fill(~valid, _NEG_INF)
    m_loc = scores.amax(-1)  # (B, g, H, 1)
    p = torch.exp(scores - m_loc[..., None])
    p = p.masked_fill(~valid, 0.0)
    l_loc = p.sum(-1)  # (B, g, H, 1)
    o_loc = torch.einsum("bghqk,bgkhd->bgqhd", p, vr)

    # The group's combine: pmax and psum over the rank dim.
    m_g = m_loc.amax(1, keepdim=True)
    corr = torch.exp(m_loc - m_g)
    l_g = (l_loc * corr).sum(1)  # (B, H, 1)
    o_g = (o_loc * corr.transpose(2, 3)[..., None]).sum(1)  # (B, 1, H, D)
    out = o_g / l_g.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype), k_cache, v_cache


__all__ = ["applicable", "shard_map_attn_decode"]
