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
On a :class:`~repro_torch.parallel.group.RankGroup` the same body runs
as the reference's does, once per process: the rank holds only its time
slice ``(B, S/g, KV, D)`` at offset ``r * S/g`` (the reference's
``cache_spec = P(batch, "model", None, None)``, which its
``cache_leaf_spec`` gives every cache of 1024 positions or more that the
group divides; :meth:`Model.init_cache
<repro_torch.models.model.Model.init_cache>` sizes it by
:func:`cache_positions`) and combines with
:func:`~repro_torch.parallel.collectives.pmax` and two
:func:`~repro_torch.parallel.collectives.all_reduce` over the group.
The reference computes with ``jnp`` einsums and XLA collectives, not
Pallas, so plain PyTorch ops are its faithful port.  The group has no
batch axis (the reference's ``BATCH_AXES``), so the batch always
divides.
"""

from __future__ import annotations

import math

import torch

from repro_torch.parallel.collectives import all_reduce, pmax
from repro_torch.parallel.group import RankGroup
from repro_torch.parallel.sharding import (MODEL_AXIS, active_group,
                                           cache_leaf_spec, shard_shape)

_NEG_INF = -1e30
_TIME = 2  # a decode cache leaf is (periods, B, S, ...)


def _guard(cache_len: int, window, g: int) -> bool:
    """The reference's guard on a cache of ``cache_len`` positions in all:
    a group of more than one rank, no sliding window, the length a
    multiple of the group and at least 1024."""
    return g > 1 and window is None and cache_len % g == 0 \
        and cache_len >= 1024


def applicable(k_cache: torch.Tensor, window,
               time_slice: bool = False) -> bool:
    """The reference's guard, on the full cache length.  On a
    :class:`RankGroup` the cache applies where :func:`cache_positions`
    cut it to the rank's slice (``time_slice``, which
    :meth:`Model.init_cache <repro_torch.models.model.Model.init_cache>`
    records); a whole cache there takes the plain decode."""
    group = active_group()
    if group is None:
        return False
    s = k_cache.shape[1]
    if isinstance(group, RankGroup):
        if not time_slice:
            return False
        s *= group.size
    return _guard(s, window, group.size)


def cache_block(shape) -> tuple:
    """This process's block of a decode-cache leaf whose whole shape is
    ``shape`` (``(periods, B, ...)``): all of it, but on a
    :class:`RankGroup` of g > 1 ranks its block by the reference's
    :func:`~repro_torch.parallel.sharding.cache_leaf_spec` on
    ``Mesh(("model",), (g,))``: the rule cuts the largest dim past the
    batch of 1024 or more that g divides (an attention cache's time axis,
    a recurrent state's d_inner or the mLSTM's key dim)."""
    from repro_torch.launch.mesh import Mesh

    shape = tuple(shape)
    group = active_group()
    if not isinstance(group, RankGroup) or group.size <= 1:
        return shape
    mesh = Mesh((MODEL_AXIS,), (group.size,))
    return shard_shape(cache_leaf_spec(shape, mesh), shape, mesh)


def cache_positions(shape) -> int:
    """How many of the positions of an attention cache leaf whose whole
    shape is ``shape`` (``(periods, B, S, ...)``) this process holds
    (:func:`cache_block`): all of them, but on a :class:`RankGroup` of g
    > 1 ranks the rank's time slice, ``S / g``, where the rule cuts the
    time axis (1024 positions or more, divisible by g), whatever the
    decode attention.  Raises where the rule cuts another dim, which no
    per-rank attention decode reads."""
    shape = tuple(shape)
    held = cache_block(shape)
    if any(h != n for i, (h, n) in enumerate(zip(held, shape))
           if i != _TIME):
        raise NotImplementedError(
            f"a decode cache of {shape} on a RankGroup of "
            f"{active_group().size}: the reference's rule cuts it to "
            f"{held}, not on its time axis")
    return held[_TIME]


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
    the port's unsharded ``attn_decode`` does.  On a :class:`RankGroup`
    they are this rank's (B, S/g, KV, D) time slices.
    """
    group = active_group()
    if isinstance(group, RankGroup):
        # One process, one time slice; the combine crosses processes.
        n, first = 1, group.rank

        def amax(t):
            return pmax(t, group=group)

        def total(t):
            return all_reduce(t, group=group)
    else:
        # One process holds every rank's slice; the combine is over dim 1.
        n, first = group.size, 0

        def amax(t):
            return t.amax(1, keepdim=True)

        def total(t):
            return t.sum(1, keepdim=True)
    b, s, kv, d = k_cache.shape
    h = q.shape[2]
    s_loc = s // n
    k_c = k_cache.view(b, n, s_loc, kv, d)
    v_c = v_cache.view(b, n, s_loc, kv, d)
    # The masked write lands in the one slice that holds pos, in place.
    j = pos // s_loc - first
    if 0 <= j < n:
        k_c[:, j, pos % s_loc] = k_new[:, 0].to(k_c.dtype)
        v_c[:, j, pos % s_loc] = v_new[:, 0].to(v_c.dtype)

    # Each slice's partial attention, in fp32.
    rep = h // kv
    kr = k_c.repeat_interleave(rep, dim=3).float()  # (B, n, s_loc, H, D)
    vr = v_c.repeat_interleave(rep, dim=3).float()
    scores = torch.einsum("bqhd,bgkhd->bghqk", q.float(), kr) / math.sqrt(d)
    offset = (first + torch.arange(n, device=q.device)[:, None]) * s_loc
    local_idx = torch.arange(s_loc, device=q.device)[None, :]
    valid = (local_idx + offset <= pos)[None, :, None, None, :]
    scores = scores.masked_fill(~valid, _NEG_INF)
    m_loc = scores.amax(-1)  # (B, n, H, 1)
    p = torch.exp(scores - m_loc[..., None])
    p = p.masked_fill(~valid, 0.0)
    l_loc = p.sum(-1)  # (B, n, H, 1)
    o_loc = torch.einsum("bghqk,bgkhd->bgqhd", p, vr)

    # The group's combine: pmax and two psums.
    m_g = amax(m_loc)
    corr = torch.exp(m_loc - m_g)
    l_g = total(l_loc * corr)[:, 0]  # (B, H, 1)
    o_g = total(o_loc * corr.transpose(2, 3)[..., None])[:, 0]  # (B, 1, H, D)
    out = o_g / l_g.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype), k_cache, v_cache


def slice_attention(q: torch.Tensor, k_slice: torch.Tensor,
                    v_slice: torch.Tensor, *, group: RankGroup
                    ) -> torch.Tensor:
    """Attention of q (B, 1, H, D) over every position of a cache whose
    time axis ``group`` holds in slices, this rank's (B, S/g, KV, D): the
    rank's partial softmax over its slice, combined as
    :func:`shard_map_attn_decode`'s body combines, by one
    :func:`~repro_torch.parallel.collectives.pmax` and one
    :func:`~repro_torch.parallel.collectives.all_reduce` of the output
    and the denominator joined.  Every position is valid (an
    encoder-decoder's cross cache) and nothing is written.  Decode only:
    ``pmax`` refuses grad."""
    h, d = q.shape[2:]
    rep = h // k_slice.shape[2]
    kr = k_slice.repeat_interleave(rep, dim=2).float()
    vr = v_slice.repeat_interleave(rep, dim=2).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / math.sqrt(d)
    m_loc = scores.amax(-1)  # (B, H, 1)
    p = torch.exp(scores - m_loc[..., None])
    corr = torch.exp(m_loc - pmax(m_loc, group=group)).transpose(1, 2)
    o_loc = torch.einsum("bhqk,bkhd->bqhd", p, vr)  # (B, 1, H, D)
    l_loc = p.sum(-1).transpose(1, 2)[..., None]  # (B, 1, H, 1)
    both = all_reduce(torch.cat([o_loc, l_loc], -1) * corr[..., None],
                      group=group)
    out = both[..., :d] / both[..., d:].clamp_min(1e-30)
    return out.to(q.dtype)


__all__ = ["applicable", "cache_block", "cache_positions",
           "shard_map_attn_decode", "slice_attention"]
