"""Parameter counts and model FLOPs from a config.

Port of ``count_params``, ``active_params`` and ``model_flops_for`` from
``repro.roofline.analysis``.  The reference counts the leaves of
``jax.eval_shape`` of its ``Model.init``; the port builds its own
``Model.init`` on the ``"meta"`` device, which allocates and draws
nothing, and counts the leaves' elements: the same tree, so the same
count, and no 398e9 random numbers for Jamba.  The reference's HLO
parsing (``parse_collectives``, ``analyze``) reads XLA's compiled text
and waits for the port's own tooling (ROADMAP A8).
"""

from __future__ import annotations

import functools
import math

from repro_torch.models.model import build_model
from repro_torch.tree import leaves


@functools.lru_cache(maxsize=None)
def count_params(cfg) -> float:
    """Total parameter count of ``cfg``'s model (every leaf, fp32 ones
    included), summed as floats in the reference's leaf order.  Cached
    per config: the configs are frozen, and a full-width meta init of
    80 layers takes a second or two."""
    state = build_model(cfg).init(0, device="meta")
    return sum(float(math.prod(t.shape)) for t in leaves(state))


def active_params(cfg) -> float:
    """Active (per-token) params: MoE counts only top-k + shared experts."""
    total = count_params(cfg)
    if not cfg.moe:
        return total
    # subtract the inactive routed experts' share
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    n_moe_layers = cfg.num_layers // cfg.moe.every_k_layers
    routed = 3.0 * d * f * e * n_moe_layers
    active_routed = 3.0 * d * f * k * n_moe_layers
    return total - routed + active_routed


def model_flops_for(cfg, shape_cfg, kind: str) -> float:
    """MODEL_FLOPS = 6*N_active*D for training; 2*N_active*D for inference
    forward; decode D = global_batch tokens (one step)."""
    n = active_params(cfg)
    if kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape_cfg.global_batch


__all__ = ["count_params", "active_params", "model_flops_for"]
