"""Model assembly (dense family) — port of ``repro.models.model``.

A model is a stack of **periods**, the smallest repeating layer pattern
(dense: one attention + MLP layer).  The state keeps the reference's
parameter tree: ``state["layers"][j]`` holds pattern slot j with every
leaf stacked over periods on dim 0, so :mod:`repro_torch.convert` maps the
reference's params leaf for leaf.  The other families (MoE, hybrid, SSM,
VLM, audio) raise ``NotImplementedError`` until their slices land.

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
from repro_torch.models import layers
from repro_torch.models.layers import AttnDims
from repro_torch.parallel.context import get_overlap, overlap_context
from repro_torch.parallel.sharding import active_group, tp_group

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # attn (mla | mamba | mlstm | slstm wait for their slices)
    ffn: str  # mlp (moe | none wait for their slices)


def layer_pattern(cfg: ModelConfig) -> list[LayerSpec]:
    """The repeating period of layer kinds for this architecture."""
    if cfg.family is not Family.DENSE or cfg.moe or cfg.mla:
        item = 5 if cfg.family is Family.MOE or cfg.moe else 7
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family is not ported yet "
            f"(ROADMAP queue A, item {item})"
        )
    return [LayerSpec("attn", "mlp")]


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


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer_init(gen, cfg: ModelConfig, device):
    dt = _dtype(cfg)
    return {
        "norm1": layers.norm_init(cfg.d_model, cfg.norm, dt, device),
        "attn": layers.attn_init(gen, _attn_dims(cfg), dt, device),
        "norm2": layers.norm_init(cfg.d_model, cfg.norm, dt, device),
        "ffn": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def _layer_apply(p, cfg: ModelConfig, x, positions):
    h = layers.apply_norm(p["norm1"], x, cfg.norm)
    x = x + layers.attn_apply(
        p["attn"], h, _attn_dims(cfg),
        rope_theta=cfg.rope_theta, positions=positions, window=_window(cfg),
    )
    h = layers.apply_norm(p["norm2"], x, cfg.norm)
    return x + layers.mlp_apply(p["ffn"], h)


def _remat_layer(p, cfg: ModelConfig, x, positions, overlap, group):
    """A period under recomputation.  The backward reruns it after the
    forward's overlap context and TP group have been left, so it enters
    the ones the forward ran in."""
    with overlap_context(overlap), tp_group(group):
        return _layer_apply(p, cfg, x, positions)


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


def _layer_decode(p, cfg: ModelConfig, x, cache, pos: int):
    h = layers.apply_norm(p["norm1"], x, cfg.norm)
    y, cache = layers.attn_decode(
        p["attn"], h, cache, pos, _attn_dims(cfg),
        rope_theta=cfg.rope_theta, window=_window(cfg),
    )
    x = x + y
    h = layers.apply_norm(p["norm2"], x, cfg.norm)
    return x + layers.mlp_apply(p["ffn"], h), cache


class Model:
    """Decoder LM (dense family)."""

    def __init__(self, config: ModelConfig):
        self.config = config
        self.pattern = layer_pattern(config)
        if config.encdec is not None or config.frontend is not None:
            raise NotImplementedError(
                f"{config.name}: encoder/frontend models are not ported yet "
                "(ROADMAP queue A, item 7)"
            )
        self.n_periods = config.num_layers // len(self.pattern)
        self._remat = _remat_kwargs(config) if config.remat else None

    # ---- init -----------------------------------------------------------
    def init(self, seed: int = 0, *, device=None) -> dict:
        """Random weights from a seeded ``torch.Generator`` on ``device``."""
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
            "layers": [
                _stack([
                    _layer_init(gen, cfg, dev) for _ in range(self.n_periods)
                ])
            ],
        }
        if not cfg.tie_embeddings:
            state["unembed"] = (
                torch.randn((cfg.d_model, cfg.vocab_size), generator=gen,
                            device=dev) * std
            ).to(dt)
        return state

    # ---- forward ----------------------------------------------------------
    def forward(self, state, batch: dict):
        """batch keys: tokens (B, S).  Returns (logits, aux_loss)."""
        cfg = self.config
        tokens = batch["tokens"]
        x = state["embed"][tokens].to(_dtype(cfg))
        b, s = tokens.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        periods = _unstack(state["layers"][0], self.n_periods)
        if self._remat is not None and torch.is_grad_enabled():
            # Each period's activations are recomputed in the backward,
            # as the reference's ``jax.checkpoint`` around its period.  A
            # period draws no random numbers, so no RNG state is kept.
            ctx = (get_overlap(), active_group())
            for period in periods:
                x = tcp.checkpoint(_remat_layer, period, cfg, x, positions,
                                   *ctx, use_reentrant=False,
                                   preserve_rng_state=False, **self._remat)
        else:
            for period in periods:
                x = _layer_apply(period, cfg, x, positions)
        x = layers.apply_norm(state["final_norm"], x, cfg.norm)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
        cfg = self.config
        dev = resolve_device(device)
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        s = min(cache_len, cfg.sliding_window or cache_len)
        shape = (self.n_periods, batch, s, kv, hd)
        return [{
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        }]

    def decode_step(self, state, cache, tokens, pos: int):
        """tokens: (B, 1) int; pos: position. -> (logits, cache).

        The cache is updated in place and returned.
        """
        cfg = self.config
        x = state["embed"][tokens].to(_dtype(cfg))
        for i in range(self.n_periods):
            x, _ = _layer_decode(
                _index(state["layers"][0], i), cfg, x,
                _index(cache[0], i), pos,
            )
        x = layers.apply_norm(state["final_norm"], x, cfg.norm)
        return self._unembed(state, x), cache


def build_model(config: ModelConfig) -> Model:
    return Model(config)
