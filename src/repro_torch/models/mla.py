"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Port of ``repro.models.mla``.  KV activations are compressed into a
low-rank latent ``c_kv`` of ``kv_lora_rank`` dims plus one shared RoPE key
head; the decode cache holds only (c_kv, k_rope), the architecture's whole
point, and each decode step up-projects the whole latent cache to per-head
K and V (the reference's trade of compute for a cache about 1/10 the
size).  Prefill materialises per-head K and V from the latent, which is
mathematically the same.  q and k heads are ``nope_head_dim +
rope_head_dim`` wide, v heads ``v_head_dim``: the attention keeps them
apart and scales by 1/sqrt(q's width).

On a rank of a group of processes (a ``RankGroup``) the params hold the
rank's blocks: ``wq``, ``w_uk`` and ``w_uv`` by their columns (h/g heads
a rank where g divides h), ``wo`` by rows, ``w_dkv`` and ``w_kr`` whole.
So the latent and the shared rope key are the same on every rank, no K/V
crosses the group, and the group sums the ranks' partial output
projections (:func:`~repro_torch.models.layers.rank_output`: a
reduce-scatter along the sequence where the input is the rank's sequence
block, else an ``all_reduce``).  Where g does not divide h but divides a
projection's columns (the reference's ``fix_param_spec`` keeps a cut
wherever g divides the dimension), a rank's column block straddles heads:
the rank gathers the blocks to whole heads, computes every head, and
multiplies by ``wo``'s row block only the columns that block owns, as
GQA does for heads the group does not divide.  The decode cache holds
the latent and rope key of the rank's time slice where the reference's
rule cuts its time axis, and the ranks gather the slices each step (the
reference has no ``shard_map`` form of MLA decode).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models import layers
from repro_torch.parallel.collectives import (all_gather, all_reduce,
                                              replicated)
from repro_torch.parallel.sharding import MODEL_AXIS, P
from repro_torch.models.layers import (
    apply_rope,
    blockwise_attention,
    cache_attention,
)

_ROPE_THETA = 10000.0  # the reference's plain RoPE on the rope part


def mla_init(gen, d_model: int, num_heads: int, cfg: MLAConfig, dtype,
             device):
    qk_head = cfg.nope_head_dim + cfg.rope_head_dim

    def dense(i, o):
        return layers.dense_init(gen, i, o, dtype, device)

    return {
        # Q: full rank (V2-Lite has no Q compression)
        "wq": dense(d_model, num_heads * qk_head),
        # KV latent down-projection and the shared rope key
        "w_dkv": dense(d_model, cfg.kv_lora_rank),
        "w_kr": dense(d_model, cfg.rope_head_dim),
        # latent -> per-head K (nope) and V
        "w_uk": dense(cfg.kv_lora_rank, num_heads * cfg.nope_head_dim),
        "w_uv": dense(cfg.kv_lora_rank, num_heads * cfg.v_head_dim),
        "wo": dense(num_heads * cfg.v_head_dim, d_model),
    }



def mla_param_specs():
    """Heads over the model axis; the shared latent and rope-key
    down-projections replicated."""
    return {
        "wq": P(None, MODEL_AXIS),
        "w_dkv": P(None, None),
        "w_kr": P(None, None),
        "w_uk": P(None, MODEL_AXIS),
        "w_uv": P(None, MODEL_AXIS),
        "wo": P(MODEL_AXIS, None),
    }

def _project(params, x, num_heads: int, cfg: MLAConfig, positions,
             group=None):
    """Q (B, S, heads, qk), the latent (B, S, r) and the shared rope key
    (B, S, 1, rope).  With ``group`` (a ``RankGroup``) ``x`` is the
    layer's input (:func:`~repro_torch.models.layers.rank_input`), Q's
    heads are the rank's (:func:`_heads`), and the whole latent and
    rope-key projections, used here only for the rank's part, are marked
    ``replicated``: their gradients are summed over the ranks."""
    b, s, _ = x.shape
    qk_head = cfg.nope_head_dim + cfg.rope_head_dim
    w_dkv, w_kr = params["w_dkv"], params["w_kr"]
    if group is not None:
        w_dkv, w_kr = (replicated(w, group=group) for w in (w_dkv, w_kr))
    q = _heads(x, params["wq"], num_heads, qk_head, group)
    q_nope, q_rope = q.split([cfg.nope_head_dim, cfg.rope_head_dim], dim=-1)
    q = torch.cat([q_nope, apply_rope(q_rope, positions, _ROPE_THETA)], -1)
    c_kv = x @ w_dkv  # (B, S, r)
    k_rope = apply_rope(
        (x @ w_kr).view(b, s, 1, cfg.rope_head_dim), positions, _ROPE_THETA,
    )
    return q, c_kv, k_rope


def _heads(inp, w, num_heads: int, width: int, group):
    """``inp @ w`` as (B, S, heads, width): every head, or on a rank
    (``w`` its column block of the ``num_heads`` heads) its h/g heads
    where g divides h, else every head, the column blocks gathered
    (:func:`~repro_torch.models.layers._rank_heads`)."""
    if group is None:
        return (inp @ w).view(*inp.shape[:2], num_heads, width)
    return layers._rank_heads(inp, w, num_heads, width, group,
                              mine=num_heads % group.size == 0)


def _expand_kv(params, c_kv, k_rope, num_heads: int, cfg: MLAConfig,
               group=None):
    """Per-head K (nope and the shared rope key) and V from the latent:
    every head, or on a rank its heads (:func:`_heads`)."""
    b, s, _ = c_kv.shape
    k_nope = _heads(c_kv, params["w_uk"], num_heads, cfg.nope_head_dim,
                    group)
    v = _heads(c_kv, params["w_uv"], num_heads, cfg.v_head_dim, group)
    n = k_nope.shape[2]
    k = torch.cat(
        [k_nope, k_rope.expand(b, s, n, cfg.rope_head_dim)], -1
    )
    return k, v


def _output(out, params, num_heads: int, cfg: MLAConfig, group):
    """The attention's (B, S, heads, v) output through ``wo``: whole, or
    on a rank its part (:func:`~repro_torch.models.layers._rank_part`:
    ``wo``'s row block against the columns it owns)."""
    out = out.flatten(-2)
    if group is None:
        return out @ params["wo"]
    return layers._rank_part(out, params["wo"], num_heads * cfg.v_head_dim,
                             group)


def mla_apply(params, x: torch.Tensor, num_heads: int, cfg: MLAConfig, *,
              positions: torch.Tensor, window=None,
              seq: bool = False) -> torch.Tensor:
    """Prefill (causal self-attention).  x: (B, S, d) -> (B, S, d); with
    ``seq``, on a ``RankGroup``, the rank's (B, S/g, d) sequence block in
    and out, ``positions`` the whole sequence's."""
    group = layers.rank_group()
    if group is not None:
        x = layers.rank_input(x, group, seq)
    q, c_kv, k_rope = _project(params, x, num_heads, cfg, positions, group)
    k, v = _expand_kv(params, c_kv, k_rope, num_heads, cfg, group)
    out = blockwise_attention(q, k, v, causal=True, window=window)
    y = _output(out, params, num_heads, cfg, group)
    return y if group is None else layers.rank_output(y, group, seq)


def mla_init_cache(batch: int, seq: int, cfg: MLAConfig, dtype, device, *,
                   lead: tuple = (), positions=None):
    """The MLA cache: latent and shared rope key only (its memory win),
    behind ``lead`` dims (the model's periods); ``positions`` of the
    ``seq`` held here (a rank's time slice), all of them by default."""
    held = seq if positions is None else positions
    return {
        "c_kv": torch.zeros((*lead, batch, held, cfg.kv_lora_rank),
                            dtype=dtype, device=device),
        "k_rope": torch.zeros((*lead, batch, held, 1, cfg.rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_decode(params, x: torch.Tensor, cache: dict, pos: int,
               num_heads: int, cfg: MLAConfig):
    """One-token decode.  x: (B, 1, d); cache: {"c_kv" (B, S, r),
    "k_rope" (B, S, 1, rope)}, updated in place (the reference returns a
    new one); the same dict is returned.  On a rank whose cache holds its
    time slice (``"time_slice"``) the rank whose slice holds ``pos``
    writes it, and every rank gathers the slices (one all-gather of the
    latent and rope key joined) before the up-projection."""
    b = x.shape[0]
    group = layers.rank_group()
    posv = torch.full((b, 1), pos, device=x.device)
    q, c_kv_new, k_rope_new = _project(params, x, num_heads, cfg, posv,
                                       group)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    here = c_kv.shape[1]
    first = group.rank * here if "time_slice" in cache else 0
    if first <= pos < first + here:
        c_kv[:, pos - first] = c_kv_new[:, 0].to(c_kv.dtype)
        k_rope[:, pos - first] = k_rope_new[:, 0].to(k_rope.dtype)
    if "time_slice" in cache:
        r = cfg.kv_lora_rank
        whole = all_gather(torch.cat([c_kv, k_rope.flatten(-2)], -1),
                           tiled=True, axis=1, group=group)
        c_kv, k_rope = whole[..., :r], whole[..., r:].unsqueeze(-2)
    # Up-project the whole latent cache for this step's attention.
    k, v = _expand_kv(params, c_kv, k_rope, num_heads, cfg, group)
    out = cache_attention(q, k, v, valid_len=pos + 1)
    y = _output(out, params, num_heads, cfg, group)
    return (y if group is None else all_reduce(y, group=group)), cache


__all__ = ["mla_init", "mla_param_specs", "mla_apply", "mla_init_cache",
           "mla_decode"]
