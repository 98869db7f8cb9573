"""Mixture-of-Experts FFN: top-k router and capacity-based sorted dispatch.

Port of ``repro.models.moe``.  Dispatch is sort-based (a stable argsort by
expert id, then capacity clipping) into (E, C, D) expert batches, whose
SwiGLU FFN runs as three batched GEMMs; the combine scatters the weighted
outputs back to their tokens.  Every shape is fixed by the config and the
token count, so the dispatch never reads a device value on the host: the
counts per expert come from a scatter of fixed length E, and dropped
tokens go to a dummy slot through ``torch.where``, as the reference's
``jnp.where(keep, ...)``.  No step uses atomics, so a forward gives the
same bits run to run.  The chunked expert-parallel dispatch lives in
:mod:`repro_torch.overlap.moe`.

Supports DeepSeek-style shared experts and Arctic's dense residual FFN;
both go through :func:`repro_torch.models.layers.mlp_apply`, so their up
and gate projections take the FiCCO path under an overlap context.

On a rank of a group of processes (a ``RankGroup``) the params hold the
rank's E/g experts (``P("model", None, None)``) and its blocks of the
shared and dense-residual MLPs.  As GSPMD partitions the reference's
``constrain``ed expert batches with the tokens replicated, every rank
routes and dispatches every token, runs the FFN of its own experts, and
gathers the experts' outputs for the combine, which every rank then
computes alike.  Where the input is the rank's sequence block (``seq``)
the rank first gathers every rank's normed tokens, since the reference's
capacity and its drops are over all B·S tokens, and keeps its sequence
block of the combine; the shared and dense-residual MLPs take the block
as the model's MLPs do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers
from repro_torch.parallel.collectives import (gather_replicated, rank_block,
                                              replicated)
from repro_torch.parallel.sharding import MODEL_AXIS, P

# The leaves the reference keeps in fp32 whatever the model's dtype: the
# router, whose logits are routed on in fp32.
FP32_LEAVES = frozenset({"router"})


def moe_init(gen, d_model: int, cfg: MoEConfig, dtype, device):
    e, ff = cfg.num_experts, cfg.d_ff_expert
    p = {
        "router": layers.dense_init(gen, d_model, e, torch.float32, device),
        "w_gate": _expert_init(gen, e, d_model, ff, dtype, device),
        "w_up": _expert_init(gen, e, d_model, ff, dtype, device),
        "w_down": _expert_init(gen, e, ff, d_model, dtype, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = layers.mlp_init(
            gen, d_model, ff * cfg.num_shared_experts, dtype, device
        )
    if cfg.dense_residual_ff:
        p["dense_residual"] = layers.mlp_init(
            gen, d_model, cfg.dense_residual_ff, dtype, device
        )
    return p



def moe_param_specs(cfg: MoEConfig):
    """Experts over the model axis (expert parallel); the router
    replicated; the shared experts and the dense residual as MLPs."""
    p = {
        "router": P(None, None),
        "w_gate": P(MODEL_AXIS, None, None),
        "w_up": P(MODEL_AXIS, None, None),
        "w_down": P(MODEL_AXIS, None, None),
    }
    if cfg.num_shared_experts:
        p["shared"] = layers.mlp_param_specs()
    if cfg.dense_residual_ff:
        p["dense_residual"] = layers.mlp_param_specs()
    return p

def _expert_init(gen, e, d_in, d_out, dtype, device):
    w = torch.randn((e, d_in, d_out), generator=gen, device=device)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def route(params, xf: torch.Tensor, cfg: MoEConfig):
    """The router: fp32 logits, softmax, top-k and the renormalised top-k
    weights.  xf: (T, D) -> (logits, probs (T, E) fp32, top_w, top_e (T,
    k), the experts in descending probability)."""
    logits = xf.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties toward the lower index and torch.topk does not
    # promise to on CUDA; fp32 router logits do not tie in practice.
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, top_w, top_e


def expert_capacity(cfg, tokens: int) -> int:
    """Each expert's capacity for ``tokens`` tokens under MoE config
    ``cfg``: ``capacity_factor * tokens * top_k / num_experts``, at least
    4, as the reference's."""
    return int(max(cfg.capacity_factor * tokens * cfg.top_k
                   / cfg.num_experts, 4))


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig, *,
              seq: bool = False):
    """x: (B, S, D) -> (out (B, S, D), aux loss (fp32 scalar)); with
    ``seq``, on a ``RankGroup``, the rank's (B, S/g, D) sequence block in
    and out (the aux loss over every token)."""
    group = layers.rank_group()
    x_in = x
    if seq:  # every rank's tokens, for routing and capacity over all
        x = gather_replicated(x, 1, group=group)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    xf = x.reshape(t, d)
    logits, probs, top_w, top_e = route(params, xf, cfg)

    # assignments per expert: a scatter of fixed length E (bincount would
    # read its max on the host)
    flat_e = top_e.reshape(-1)  # (T*k,)
    counts = torch.zeros((e,), dtype=torch.long, device=x.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))

    # aux losses (GShard load balance + router z-loss)
    me = probs.mean(0)  # (E,)
    ce = counts.float() / (t * k)
    lb_loss = cfg.load_balance_loss * e * torch.sum(me * ce)
    z_loss = cfg.router_z_loss * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2
    )

    capacity = expert_capacity(cfg, t)

    # ---- sorted capacity dispatch -----------------------------------
    flat_w = top_w.reshape(-1)
    flat_tok = torch.arange(t * k, device=x.device) // k  # jnp.repeat
    # The stable sort decides which tokens are dropped past capacity.
    order = torch.argsort(flat_e, stable=True)
    se, stok = flat_e[order], flat_tok[order]
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix
    pos = torch.arange(t * k, device=x.device) - starts[se]
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, e * capacity)  # dummy tail

    # A rank's experts see only their tokens: the dispatched rows'
    # gradient is summed over the ranks (the router's is every rank's
    # alike, since the combine is).  Where the group does not divide the
    # experts every rank runs all of them alike, and its gradient is
    # whole already.
    mine = params["w_up"].shape[0]  # the experts this rank holds
    src = xf if mine == e else replicated(xf, group=group)
    disp = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=x.device)
    disp[slot] = src[stok]
    expert_in = disp[: e * capacity].view(e, capacity, d)
    if mine != e:  # this rank's rows of expert_in: a view
        expert_in = expert_in[group.rank * mine:(group.rank + 1) * mine]

    # ---- expert FFN (the paper's EP hot spot: grouped GEMMs) ----------
    h = torch.bmm(expert_in, params["w_up"])
    g = torch.bmm(expert_in, params["w_gate"])
    h = F.silu(g) * h
    expert_out = torch.bmm(h, params["w_down"])
    if mine != e:  # every rank's experts, for a combine every rank does
        expert_out = gather_replicated(expert_out, 0, group=group)

    # ---- combine back -------------------------------------------------
    # The reference scatter-adds each kept assignment's weighted output to
    # its token.  Each token has exactly k assignments, so the same sum is
    # a gather in (token, k) order and a sum over k: no atomics, and the
    # same bits run to run.  A dropped assignment reads the zero row.
    flat_out = torch.cat(
        [expert_out.reshape(e * capacity, d),
         torch.zeros((1, d), dtype=x.dtype, device=x.device)]
    )
    slot_tok = torch.empty_like(slot).scatter_(0, order, slot)
    routed = flat_out[slot_tok] * flat_w[:, None].to(x.dtype)
    out = routed.view(b, s, k, d).sum(2)
    if seq:  # the rank's block of a combine every rank computed alike
        out = rank_block(out, 1, group=group)

    if "shared" in params:
        out = out + layers.mlp_apply(
            params["shared"], x_in, cfg.d_ff_expert * cfg.num_shared_experts,
            seq=seq)
    if "dense_residual" in params:
        out = out + layers.mlp_apply(params["dense_residual"], x_in,
                                     cfg.dense_residual_ff, seq=seq)
    return out, lb_loss + z_loss


__all__ = ["FP32_LEAVES", "moe_init", "moe_param_specs", "route",
           "moe_apply"]
