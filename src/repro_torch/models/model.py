"""Model assembly (dense and MoE families) — port of ``repro.models.model``.

A model is a stack of **periods**, the smallest repeating layer pattern
(dense: one attention + MLP layer; MoE: ``every_k_layers`` layers, the
last with an MoE FFN; attention is MLA where the config has one).  The
state keeps the reference's parameter tree: ``state["layers"][j]`` holds
pattern slot j with every leaf stacked over periods on dim 0, so
:mod:`repro_torch.convert` maps the reference's params leaf for leaf.  The
other families (hybrid, SSM, VLM, audio) raise ``NotImplementedError``
until their slices land.

Interface (used by serve/launch):
    model = build_model(config)
    state         = model.init(seed, device=...)
    logits, aux   = model.forward(state, batch)
    loss, parts   = model.loss(state, batch)
    cache         = model.init_cache(batch, cache_len, device=...)
    logits, cache = model.decode_step(state, cache, tokens, pos)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint as tcp

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, mla, moe
from repro_torch.models.layers import AttnDims
from repro_torch.parallel.context import get_overlap, overlap_context
from repro_torch.parallel.sharding import active_group, tp_group

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # attn | mla (mamba | mlstm | slstm wait for their slices)
    ffn: str  # mlp | moe


def layer_pattern(cfg: ModelConfig) -> list[LayerSpec]:
    """The repeating period of layer kinds for this architecture."""
    if cfg.family not in (Family.DENSE, Family.MOE):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family is not ported yet "
            "(ROADMAP queue A, item 7)"
        )
    mixer = "mla" if cfg.mla else "attn"
    if cfg.moe:
        period = cfg.moe.every_k_layers
        return [
            LayerSpec(mixer, "moe" if i == period - 1 else "mlp")
            for i in range(period)
        ]
    return [LayerSpec(mixer, "mlp")]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _attn_dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(
        cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    )


def _window(cfg: ModelConfig) -> Optional[int]:
    return cfg.sliding_window or None


def _index(tree, i: int):
    """Period i of a tree whose leaves are stacked over periods (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The n periods of a tree whose leaves are stacked over periods, as
    views by ``unbind``: under autograd each leaf's gradient is one
    ``stack`` of the periods', not n full-size scatters."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def _stacked_like(tree, n: int):
    """Uninitialised leaves like ``tree``'s with a leading dim of n."""
    if isinstance(tree, dict):
        return {k: _stacked_like(v, n) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stacked_like(v, n) for v in tree]
    return tree.new_empty((n, *tree.shape))


def _put(stacked, tree, i: int) -> None:
    """Copy ``tree``'s leaves into period i of ``stacked``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(stacked[k], v, i)
    elif isinstance(tree, list):
        for dst, v in zip(stacked, tree):
            _put(dst, v, i)
    else:
        stacked[i].copy_(tree)


def _layer_init(gen, spec: LayerSpec, cfg: ModelConfig, device):
    dt = _dtype(cfg)
    p: dict[str, Any] = {
        "norm1": layers.norm_init(cfg.d_model, cfg.norm, dt, device)
    }
    if spec.mixer == "attn":
        p["attn"] = layers.attn_init(gen, _attn_dims(cfg), dt, device)
    else:
        p["attn"] = mla.mla_init(gen, cfg.d_model, cfg.num_heads, cfg.mla,
                                 dt, device)
    p["norm2"] = layers.norm_init(cfg.d_model, cfg.norm, dt, device)
    if spec.ffn == "moe":
        p["ffn"] = moe.moe_init(gen, cfg.d_model, cfg.moe, dt, device)
    else:
        p["ffn"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, device)
    return p


def _layer_apply(p, spec: LayerSpec, cfg: ModelConfig, x, positions):
    """One layer.  Returns (x, aux): the MoE FFN's aux loss, or None."""
    h = layers.apply_norm(p["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        y = layers.attn_apply(
            p["attn"], h, _attn_dims(cfg), rope_theta=cfg.rope_theta,
            positions=positions, window=_window(cfg),
        )
    else:
        y = mla.mla_apply(p["attn"], h, cfg.num_heads, cfg.mla,
                          positions=positions, window=_window(cfg))
    x = x + y
    h = layers.apply_norm(p["norm2"], x, cfg.norm)
    if spec.ffn == "moe":
        y, aux = moe.moe_apply(p["ffn"], h, cfg.moe)
        return x + y, aux
    return x + layers.mlp_apply(p["ffn"], h), None


def _period_apply(period, pattern, cfg: ModelConfig, x, positions):
    """The layers of one period (period[j] holds slot j's parameters).
    Returns (x, the period's summed aux loss or None)."""
    aux = None
    for p, spec in zip(period, pattern):
        x, a = _layer_apply(p, spec, cfg, x, positions)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _remat_period(period, pattern, cfg: ModelConfig, x, positions,
                  overlap, group):
    """A period under recomputation.  The backward reruns it after the
    forward's overlap context and TP group have been left, so it enters
    the ones the forward ran in."""
    with overlap_context(overlap), tp_group(group):
        return _period_apply(period, pattern, cfg, x, positions)


# The matmul family of aten ops: what ``remat_policy="dots"`` saves, as the
# reference's ``dots_saveable`` saves the outputs of its dot products.
_DOT_OPS = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ("mm", "bmm", "addmm", "baddbmm", "matmul")
)


def _save_dots(ctx, op, *args, **kwargs):
    return (tcp.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else tcp.CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return tcp.create_selective_checkpoint_contexts(_save_dots)


def _remat_kwargs(cfg: ModelConfig) -> dict:
    """``torch.utils.checkpoint`` arguments for the config's policy.

    ``"nothing"`` keeps nothing inside a period (``nothing_saveable``);
    ``"dots"`` keeps the matmuls' outputs (``dots_saveable``).  K2's
    autograd Function is no aten matmul, so it is recomputed under both.
    """
    if cfg.remat_policy == "nothing":
        return {}
    if cfg.remat_policy == "dots":
        return {"context_fn": _dots_contexts}
    raise ValueError(
        f"remat_policy must be 'nothing' or 'dots', got {cfg.remat_policy!r}"
    )


def _layer_init_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      cache_len: int, device, lead: tuple):
    dt = _dtype(cfg)
    if spec.mixer == "mla":
        return mla.mla_init_cache(batch, cache_len, cfg.mla, dt, device,
                                  lead=lead)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    s = min(cache_len, cfg.sliding_window or cache_len)
    shape = (*lead, batch, s, kv, hd)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def _layer_decode(p, spec: LayerSpec, cfg: ModelConfig, x, cache, pos: int):
    h = layers.apply_norm(p["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        y, cache = layers.attn_decode(
            p["attn"], h, cache, pos, _attn_dims(cfg),
            rope_theta=cfg.rope_theta, window=_window(cfg),
        )
    else:
        y, cache = mla.mla_decode(p["attn"], h, cache, pos, cfg.num_heads,
                                  cfg.mla)
    x = x + y
    h = layers.apply_norm(p["norm2"], x, cfg.norm)
    if spec.ffn == "moe":
        y, _ = moe.moe_apply(p["ffn"], h, cfg.moe)
    else:
        y = layers.mlp_apply(p["ffn"], h)
    return x + y, cache


class Model:
    """Decoder LM (dense and MoE families)."""

    def __init__(self, config: ModelConfig):
        self.config = config
        self.pattern = layer_pattern(config)
        if config.encdec is not None or config.frontend is not None:
            raise NotImplementedError(
                f"{config.name}: encoder/frontend models are not ported yet "
                "(ROADMAP queue A, item 7)"
            )
        if config.num_layers % len(self.pattern):
            raise ValueError(
                f"{config.name}: {config.num_layers} layers not divisible "
                f"by period {len(self.pattern)}"
            )
        self.n_periods = config.num_layers // len(self.pattern)
        self._remat = _remat_kwargs(config) if config.remat else None

    # ---- init -----------------------------------------------------------
    def init(self, seed: int = 0, *, device=None) -> dict:
        """Random weights from a seeded ``torch.Generator`` on ``device``.

        Each stacked leaf is allocated once and filled period by period,
        so at no time does the device hold more than the state and one
        period's weights (with one leaf's fp32 draw).
        """
        cfg = self.config
        dev = resolve_device(device)
        dt = _dtype(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        std = 0.02
        state: dict[str, Any] = {
            "embed": (
                torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                            device=dev) * std
            ).to(dt),
            "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dt, dev),
        }
        stacked = None
        for i in range(self.n_periods):
            period = [_layer_init(gen, spec, cfg, dev)
                      for spec in self.pattern]
            if stacked is None:
                stacked = _stacked_like(period, self.n_periods)
            _put(stacked, period, i)
            del period
        state["layers"] = stacked
        if not cfg.tie_embeddings:
            state["unembed"] = (
                torch.randn((cfg.d_model, cfg.vocab_size), generator=gen,
                            device=dev) * std
            ).to(dt)
        return state

    # ---- forward ----------------------------------------------------------
    def forward(self, state, batch: dict):
        """batch keys: tokens (B, S).  Returns (logits, aux_loss): aux is
        the MoE layers' summed load-balance and z losses (0 without)."""
        cfg = self.config
        tokens = batch["tokens"]
        x = state["embed"][tokens].to(_dtype(cfg))
        b, s = tokens.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        slots = [_unstack(slot, self.n_periods) for slot in state["layers"]]
        remat = self._remat is not None and torch.is_grad_enabled()
        # Each period's activations are recomputed in the backward, as the
        # reference's ``jax.checkpoint`` around its period.  A period draws
        # no random numbers, so no RNG state is kept.
        ctx = (get_overlap(), active_group()) if remat else ()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.n_periods):
            period = [periods[i] for periods in slots]
            if remat:
                x, a = tcp.checkpoint(
                    _remat_period, period, self.pattern, cfg, x, positions,
                    *ctx, use_reentrant=False, preserve_rng_state=False,
                    **self._remat)
            else:
                x, a = _period_apply(period, self.pattern, cfg, x, positions)
            if a is not None:
                aux = aux + a
        x = layers.apply_norm(state["final_norm"], x, cfg.norm)
        return self._unembed(state, x), aux

    def _unembed(self, state, x):
        w = (
            state["embed"].T
            if self.config.tie_embeddings
            else state["unembed"]
        )
        return x @ w.to(x.dtype)

    def loss(self, state, batch: dict):
        """Vocab-wise fp32 cross entropy, as the reference's ``Model.loss``.

        batch keys: tokens, labels (B, S).  Returns (ce + aux, {"ce",
        "aux"}); aux is 0 for the dense family.  The max is detached and
        the reductions run over the vocab dim in the reference's order:
        logsumexp per position, then the mean over (B, S - 1).  The gold
        logit is a gather, which equals the reference's masked sum over
        the vocab exactly (one nonzero term).
        """
        logits, aux = self.forward(state, batch)
        labels = batch["labels"]
        lg = logits[:, :-1].float()
        tg = labels[:, 1:].long()
        m = lg.amax(dim=-1, keepdim=True).detach()
        logz = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
        gold = lg.gather(-1, tg[..., None])[..., 0]
        ce = (logz - gold).mean()
        return ce + aux, {"ce": ce, "aux": aux}

    # ---- decode ------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, *, device=None):
        """One cache per pattern slot, stacked over periods: attention
        keeps K and V, MLA its latent and shared rope key."""
        dev = resolve_device(device)
        return [
            _layer_init_cache(spec, self.config, batch, cache_len, dev,
                              (self.n_periods,))
            for spec in self.pattern
        ]

    def decode_step(self, state, cache, tokens, pos: int):
        """tokens: (B, 1) int; pos: position. -> (logits, cache).

        The cache is updated in place and returned.
        """
        cfg = self.config
        x = state["embed"][tokens].to(_dtype(cfg))
        for i in range(self.n_periods):
            for j, spec in enumerate(self.pattern):
                x, _ = _layer_decode(
                    _index(state["layers"][j], i), spec, cfg, x,
                    _index(cache[j], i), pos,
                )
        x = layers.apply_norm(state["final_norm"], x, cfg.norm)
        return self._unembed(state, x), cache


def build_model(config: ModelConfig) -> Model:
    return Model(config)
