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
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models import layers
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

def _project(params, x, num_heads: int, cfg: MLAConfig, positions):
    b, s, _ = x.shape
    qk_head = cfg.nope_head_dim + cfg.rope_head_dim
    q = (x @ params["wq"]).view(b, s, num_heads, qk_head)
    q_nope, q_rope = q.split([cfg.nope_head_dim, cfg.rope_head_dim], dim=-1)
    q = torch.cat([q_nope, apply_rope(q_rope, positions, _ROPE_THETA)], -1)
    c_kv = x @ params["w_dkv"]  # (B, S, r)
    k_rope = apply_rope(
        (x @ params["w_kr"]).view(b, s, 1, cfg.rope_head_dim),
        positions, _ROPE_THETA,
    )
    return q, c_kv, k_rope


def _expand_kv(params, c_kv, k_rope, num_heads: int, cfg: MLAConfig):
    b, s, _ = c_kv.shape
    k_nope = (c_kv @ params["w_uk"]).view(b, s, num_heads, cfg.nope_head_dim)
    v = (c_kv @ params["w_uv"]).view(b, s, num_heads, cfg.v_head_dim)
    k = torch.cat(
        [k_nope, k_rope.expand(b, s, num_heads, cfg.rope_head_dim)], -1
    )
    return k, v


def mla_apply(params, x: torch.Tensor, num_heads: int, cfg: MLAConfig, *,
              positions: torch.Tensor, window=None) -> torch.Tensor:
    """Prefill (causal self-attention).  x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    q, c_kv, k_rope = _project(params, x, num_heads, cfg, positions)
    k, v = _expand_kv(params, c_kv, k_rope, num_heads, cfg)
    out = blockwise_attention(q, k, v, causal=True, window=window)
    return out.reshape(b, s, num_heads * cfg.v_head_dim) @ params["wo"]


def mla_init_cache(batch: int, seq: int, cfg: MLAConfig, dtype, device, *,
                   lead: tuple = ()):
    """The MLA cache: latent and shared rope key only (its memory win),
    behind ``lead`` dims (the model's periods)."""
    return {
        "c_kv": torch.zeros((*lead, batch, seq, cfg.kv_lora_rank),
                            dtype=dtype, device=device),
        "k_rope": torch.zeros((*lead, batch, seq, 1, cfg.rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_decode(params, x: torch.Tensor, cache: dict, pos: int,
               num_heads: int, cfg: MLAConfig):
    """One-token decode.  x: (B, 1, d); cache: {"c_kv" (B, S, r),
    "k_rope" (B, S, 1, rope)}, updated in place (the reference returns a
    new one); the same dict is returned."""
    b = x.shape[0]
    posv = torch.full((b, 1), pos, device=x.device)
    q, c_kv_new, k_rope_new = _project(params, x, num_heads, cfg, posv)
    cache["c_kv"][:, pos] = c_kv_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, pos] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    # Up-project the whole latent cache for this step's attention.
    k, v = _expand_kv(params, cache["c_kv"], cache["k_rope"], num_heads, cfg)
    out = cache_attention(q, k, v, valid_len=pos + 1)
    return out.reshape(b, 1, num_heads * cfg.v_head_dim) @ params["wo"], cache


__all__ = ["mla_init", "mla_param_specs", "mla_apply", "mla_init_cache",
           "mla_decode"]
