"""Model assembly (all six families) — port of ``repro.models.model``.

A model is a stack of **periods**, the smallest repeating layer pattern
(dense: one attention + MLP layer; MoE: ``every_k_layers`` layers, the
last with an MoE FFN; attention is MLA where the config has one; Jamba
(hybrid): ``attn_every`` layers, one attention and the rest Mamba, MoE on
every ``every_k_layers``-th; xLSTM (SSM): ``slstm_every`` layers, one
sLSTM and the rest mLSTM, no FFN).  The
state keeps the reference's parameter tree: ``state["layers"][j]`` holds
pattern slot j with every leaf stacked over periods on dim 0, so
:mod:`repro_torch.convert` maps the reference's params leaf for leaf.

The audio family is an encoder-decoder: ``state["encoder"]`` holds the
bidirectional encoder's layers stacked on dim 0 and ``enc_norm`` its final
norm, and each decoder layer adds a cross-attention (``norm_cross``,
``cross``) over the encoder's output.  The VLM family prepends the stub
frontend's patch embeddings, projected by ``frontend_proj``, to the text.
A Mamba, mLSTM or sLSTM layer keeps its mixer under ``mixer``, and a
layer whose FFN is ``none`` (every xLSTM layer) has no ``norm2`` and no
``ffn``, as in the reference's tree.  Their decode caches hold recurrent
state; :func:`reset_recurrent` returns it to the start.

Interface (used by serve/launch):
    model = build_model(config)
    state         = model.init(seed, device=...)
    specs         = model.param_specs()          # a tree of P like state's
    logits, aux   = model.forward(state, batch)
    loss, parts   = model.loss(state, batch)
    cache         = model.init_cache(batch, cache_len, enc_len=..., device=...)
    cache         = model.prefill_cross(state, cache, enc_frames)  # enc-dec
    logits, cache = model.decode_step(state, cache, tokens, pos)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint as tcp

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, mamba, mla, moe, xlstm
from repro_torch.models.layers import AttnDims
from repro_torch.parallel.context import get_overlap, overlap_context
from repro_torch.parallel.sharding import (
    MODEL_AXIS,
    P,
    active_group,
    map_specs,
    tp_group,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # attn | mla | mamba | mlstm | slstm
    ffn: str  # mlp | moe | none


# The encoder's one layer kind: bidirectional attention and an MLP.
_ENC_SPEC = LayerSpec("attn", "mlp")


def layer_pattern(cfg: ModelConfig) -> list[LayerSpec]:
    """The repeating period of layer kinds for this architecture."""
    if cfg.family is Family.SSM:
        x = cfg.xlstm
        return [
            LayerSpec("slstm" if i % x.slstm_every == x.slstm_offset
                      else "mlstm", "none")
            for i in range(x.slstm_every)
        ]
    if cfg.family is Family.HYBRID:
        h = cfg.hybrid
        k = cfg.moe.every_k_layers if cfg.moe else 0
        return [
            LayerSpec("attn" if i % h.attn_every == h.attn_offset
                      else "mamba",
                      "moe" if k and i % k == k - 1 else "mlp")
            for i in range(h.attn_every)
        ]
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


def _layer_init(gen, spec: LayerSpec, cfg: ModelConfig, device, *,
                cross: bool = False):
    dt = _dtype(cfg)
    p: dict[str, Any] = {
        "norm1": layers.norm_init(cfg.d_model, cfg.norm, dt, device)
    }
    if spec.mixer == "attn":
        p["attn"] = layers.attn_init(gen, _attn_dims(cfg), dt, device)
    elif spec.mixer == "mla":
        p["attn"] = mla.mla_init(gen, cfg.d_model, cfg.num_heads, cfg.mla,
                                 dt, device)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba.mamba_init(gen, cfg.d_model, cfg.hybrid.mamba, dt,
                                      device)
    elif spec.mixer == "mlstm":
        p["mixer"] = xlstm.mlstm_init(gen, cfg.d_model, cfg.num_heads,
                                      cfg.xlstm, dt, device)
    else:
        p["mixer"] = xlstm.slstm_init(gen, cfg.d_model, cfg.xlstm, dt, device)
    if cross:
        p["norm_cross"] = layers.norm_init(cfg.d_model, cfg.norm, dt, device)
        p["cross"] = layers.attn_init(gen, _attn_dims(cfg), dt, device)
    if spec.ffn == "none":
        return p
    p["norm2"] = layers.norm_init(cfg.d_model, cfg.norm, dt, device)
    if spec.ffn == "moe":
        p["ffn"] = moe.moe_init(gen, cfg.d_model, cfg.moe, dt, device)
    else:
        p["ffn"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, device)
    return p


def _layer_specs(spec: LayerSpec, cfg: ModelConfig, *, cross: bool = False):
    """One layer's partition specs, keyed as :func:`_layer_init`'s tree."""
    s: dict[str, Any] = {"norm1": _norm_spec(cfg)}
    if spec.mixer == "attn":
        s["attn"] = layers.attn_param_specs()
    elif spec.mixer == "mla":
        s["attn"] = mla.mla_param_specs()
    elif spec.mixer == "mamba":
        s["mixer"] = mamba.mamba_param_specs()
    elif spec.mixer == "mlstm":
        s["mixer"] = xlstm.mlstm_param_specs()
    else:
        s["mixer"] = xlstm.slstm_param_specs()
    if cross:
        s["norm_cross"] = _norm_spec(cfg)
        s["cross"] = layers.attn_param_specs()
    if spec.ffn == "none":
        return s
    s["norm2"] = _norm_spec(cfg)
    s["ffn"] = (moe.moe_param_specs(cfg.moe) if spec.ffn == "moe"
                else layers.mlp_param_specs())
    return s


def _norm_spec(cfg: ModelConfig):
    if cfg.norm == "rmsnorm":
        return {"scale": P(None)}
    if cfg.norm == "layernorm":
        return {"scale": P(None), "bias": P(None)}
    return {}


def _stacked_specs(specs):
    """Every leaf's spec with the periods (or encoder layers) dim in
    front, replicated."""
    return map_specs(lambda sp: P(None, *sp), specs)


def _layer_apply(p, spec: LayerSpec, cfg: ModelConfig, x, positions, *,
                 enc_out=None, causal: bool = True):
    """One layer.  Returns (x, aux): the MoE FFN's aux loss, or None.

    ``causal=False`` is the encoder's bidirectional self-attention (no
    window); ``enc_out`` adds the decoder's cross-attention over it.
    """
    h = layers.apply_norm(p["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        y = layers.attn_apply(
            p["attn"], h, _attn_dims(cfg), rope_theta=cfg.rope_theta,
            positions=positions, window=_window(cfg) if causal else None,
            causal=causal,
        )
    elif spec.mixer == "mla":
        y = mla.mla_apply(p["attn"], h, cfg.num_heads, cfg.mla,
                          positions=positions, window=_window(cfg))
    elif spec.mixer == "mamba":
        y = mamba.mamba_apply(p["mixer"], h, cfg.hybrid.mamba)
    elif spec.mixer == "mlstm":
        y = xlstm.mlstm_apply(p["mixer"], h, cfg.num_heads, cfg.xlstm)
    else:
        y = xlstm.slstm_apply(p["mixer"], h, cfg.xlstm)
    x = x + y
    if enc_out is not None:
        h = layers.apply_norm(p["norm_cross"], x, cfg.norm)
        x = x + layers.attn_apply(
            p["cross"], h, _attn_dims(cfg), rope_theta=cfg.rope_theta,
            positions=positions, kv_for_cross=enc_out,
        )
    if spec.ffn == "none":
        return x, None
    h = layers.apply_norm(p["norm2"], x, cfg.norm)
    if spec.ffn == "moe":
        y, aux = moe.moe_apply(p["ffn"], h, cfg.moe)
        return x + y, aux
    return x + layers.mlp_apply(p["ffn"], h), None


def _period_apply(period, pattern, cfg: ModelConfig, x, positions,
                  enc_out=None):
    """The layers of one period (period[j] holds slot j's parameters).
    Returns (x, the period's summed aux loss or None)."""
    aux = None
    for p, spec in zip(period, pattern):
        x, a = _layer_apply(p, spec, cfg, x, positions, enc_out=enc_out)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _remat_period(period, pattern, cfg: ModelConfig, x, positions,
                  enc_out, overlap, group):
    """A period under recomputation.  The backward reruns it after the
    forward's overlap context and TP group have been left, so it enters
    the ones the forward ran in.  A recurrent mixer builds its state from
    zero in every call, so the rerun reproduces the forward bit for
    bit."""
    with overlap_context(overlap), tp_group(group):
        return _period_apply(period, pattern, cfg, x, positions, enc_out)


def _remat_enc_layer(p, cfg: ModelConfig, x, positions, overlap, group):
    """An encoder layer under recomputation (as :func:`_remat_period`)."""
    with overlap_context(overlap), tp_group(group):
        return _layer_apply(p, _ENC_SPEC, cfg, x, positions,
                            causal=False)[0]


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
    if spec.mixer == "mamba":
        return mamba.mamba_init_cache(batch, cfg.d_model, cfg.hybrid.mamba,
                                      dt, device, lead=lead)
    if spec.mixer == "mlstm":
        return xlstm.mlstm_init_cache(batch, cfg.d_model, cfg.num_heads,
                                      cfg.xlstm, device, lead=lead)
    if spec.mixer == "slstm":
        return xlstm.slstm_init_cache(batch, cfg.d_model, cfg.xlstm, device,
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
    elif spec.mixer == "mla":
        y, cache = mla.mla_decode(p["attn"], h, cache, pos, cfg.num_heads,
                                  cfg.mla)
    elif spec.mixer == "mamba":
        y, cache = mamba.mamba_decode(p["mixer"], h, cache, cfg.hybrid.mamba)
    elif spec.mixer == "mlstm":
        y, cache = xlstm.mlstm_decode(p["mixer"], h, cache, cfg.num_heads,
                                      cfg.xlstm)
    else:
        y, cache = xlstm.slstm_decode(p["mixer"], h, cache, cfg.xlstm)
    x = x + y
    if "cross_k" in cache:  # the encoder-decoder's cross-attention
        h = layers.apply_norm(p["norm_cross"], x, cfg.norm)
        dims = _attn_dims(cfg)
        b = x.shape[0]
        q = (h @ p["cross"]["wq"]).view(b, 1, dims.num_heads, dims.head_dim)
        out = layers.cache_attention(
            q, cache["cross_k"], cache["cross_v"],
            valid_len=cache["cross_k"].shape[1], ring=True,
        )
        x = x + out.reshape(b, 1, -1) @ p["cross"]["wo"]
    if spec.ffn == "none":
        return x, cache
    h = layers.apply_norm(p["norm2"], x, cfg.norm)
    if spec.ffn == "moe":
        y, _ = moe.moe_apply(p["ffn"], h, cfg.moe)
    else:
        y = layers.mlp_apply(p["ffn"], h)
    return x + y, cache


# The recurrent mixers, whose decode state starts at zero in every leaf
# but the running maxima ``m``.
RECURRENT = frozenset({"mamba", "mlstm", "slstm"})


def reset_recurrent(pattern, cache) -> None:
    """Return the recurrent layers' decode state in ``cache`` (one dict
    per pattern slot, as :meth:`Model.init_cache` makes it) to the start,
    in place: Mamba's conv window and ssm state to zeros, the mLSTM's and
    sLSTM's running maxima to -1e30 and their other state to zeros.  An
    attention or MLA cache is left as it is.  For serving only: a forward
    under grad builds each mixer's state afresh and never reads a cache."""
    for spec, c in zip(pattern, cache):
        if spec.mixer in RECURRENT:
            for key, leaf in c.items():
                leaf.fill_(xlstm.M_START if key == "m" else 0.0)


class Model:
    """Decoder LM (every family) with an optional encoder (the audio
    encoder-decoder)."""

    def __init__(self, config: ModelConfig):
        self.config = config
        self.pattern = layer_pattern(config)
        self.is_encdec = config.encdec is not None
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
        period's weights (with one leaf's fp32 draw).  On the ``"meta"``
        device it allocates and draws nothing: the leaves' shapes and
        dtypes (:func:`repro_torch.roofline.count_params`).
        """
        cfg = self.config
        dev = resolve_device(device)
        dt = _dtype(cfg)
        gen = None  # the meta device draws nothing: shapes only
        if dev.type != "meta":
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
        state["layers"] = _init_stack(
            lambda: [_layer_init(gen, spec, cfg, dev, cross=self.is_encdec)
                     for spec in self.pattern], self.n_periods)
        if not cfg.tie_embeddings:
            state["unembed"] = (
                torch.randn((cfg.d_model, cfg.vocab_size), generator=gen,
                            device=dev) * std
            ).to(dt)
        if self.is_encdec:
            state["encoder"] = _init_stack(
                lambda: _layer_init(gen, _ENC_SPEC, cfg, dev),
                cfg.encdec.encoder_layers)
            state["enc_norm"] = layers.norm_init(cfg.d_model, cfg.norm, dt,
                                                 dev)
        if cfg.frontend and cfg.frontend.embed_dim:
            state["frontend_proj"] = layers.dense_init(
                gen, cfg.frontend.embed_dim, cfg.d_model, dt, dev)
        return state

    # ---- sharding specs ---------------------------------------------------
    def param_specs(self) -> dict:
        """The partition spec of every leaf of :meth:`init`'s state, as the
        reference's ``Model.param_specs``: the vocabulary of ``embed`` and
        ``unembed`` and each mixer's and FFN's heads, inner width or
        experts over ``model``; fixed for a mesh by
        :func:`repro_torch.parallel.sharding.fix_param_specs`."""
        cfg = self.config
        specs: dict[str, Any] = {
            "embed": P(MODEL_AXIS, None),
            "final_norm": _norm_spec(cfg),
            "layers": _stacked_specs([
                _layer_specs(s, cfg, cross=self.is_encdec)
                for s in self.pattern
            ]),
        }
        if not cfg.tie_embeddings:
            specs["unembed"] = P(None, MODEL_AXIS)
        if self.is_encdec:
            specs["encoder"] = _stacked_specs(_layer_specs(_ENC_SPEC, cfg))
            specs["enc_norm"] = _norm_spec(cfg)
        if cfg.frontend and cfg.frontend.embed_dim:
            specs["frontend_proj"] = P(None, None)
        return specs

    # ---- forward ----------------------------------------------------------
    def _encode(self, state, enc_frames):
        """The encoder over (B, S_enc, d) frames -> its normed output.

        Under ``remat`` each layer is recomputed in the backward, as the
        reference's ``jax.checkpoint`` around its layer (which saves
        nothing, whatever the config's policy)."""
        cfg = self.config
        x = enc_frames.to(_dtype(cfg))
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        remat = self._remat is not None and torch.is_grad_enabled()
        ctx = (get_overlap(), active_group()) if remat else ()
        for p in _unstack(state["encoder"], cfg.encdec.encoder_layers):
            if remat:
                x = tcp.checkpoint(
                    _remat_enc_layer, p, cfg, x, positions, *ctx,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, _ = _layer_apply(p, _ENC_SPEC, cfg, x, positions,
                                    causal=False)
        return layers.apply_norm(state["enc_norm"], x, cfg.norm)

    def forward(self, state, batch: dict):
        """batch keys: tokens (B, S); with the stub frontends also
        prefix_embeds (B, P, embed_dim) (VLM) or enc_frames (B, S_enc, d)
        (audio).  Returns (logits over the text tokens, aux_loss): aux is
        the MoE layers' summed load-balance and z losses (0 without)."""
        cfg = self.config
        tokens = batch["tokens"]
        x = state["embed"][tokens].to(_dtype(cfg))
        enc_out = (self._encode(state, batch["enc_frames"])
                   if self.is_encdec else None)
        prefix = cfg.frontend is not None and "prefix_embeds" in batch
        if prefix:
            pe = batch["prefix_embeds"].to(_dtype(cfg))
            if "frontend_proj" in state:
                pe = pe @ state["frontend_proj"]
            x = torch.cat([pe, x], dim=1)
        b, s = x.shape[:2]
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
                    enc_out, *ctx, use_reentrant=False,
                    preserve_rng_state=False, **self._remat)
            else:
                x, a = _period_apply(period, self.pattern, cfg, x, positions,
                                     enc_out)
            if a is not None:
                aux = aux + a
        x = layers.apply_norm(state["final_norm"], x, cfg.norm)
        if prefix:
            x = x[:, -tokens.shape[1]:]  # logits over the text segment
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
    def init_cache(self, batch: int, cache_len: int, *, enc_len: int = 0,
                   device=None):
        """One cache per pattern slot, stacked over periods: attention
        keeps K and V, MLA its latent and shared rope key, a Mamba layer
        its conv window and ssm state, an mLSTM or sLSTM layer its
        recurrent state (``cache_len`` does not size these), and an
        encoder-decoder's cross-attention the encoder's ``enc_len`` keys
        and values (``cross_k``, ``cross_v``; zeros until
        :meth:`prefill_cross`)."""
        cfg = self.config
        dev = resolve_device(device)
        caches = [
            _layer_init_cache(spec, cfg, batch, cache_len, dev,
                              (self.n_periods,))
            for spec in self.pattern
        ]
        if self.is_encdec:
            shape = (self.n_periods, batch, enc_len, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            for c in caches:
                c["cross_k"] = torch.zeros(shape, dtype=_dtype(cfg),
                                           device=dev)
                c["cross_v"] = torch.zeros(shape, dtype=_dtype(cfg),
                                           device=dev)
        return caches

    def prefill_cross(self, state, cache, enc_frames):
        """Encoder-decoder: run the encoder over (B, S_enc, d) frames and
        put each decoder layer's cross K and V of its output into the
        cache (replacing ``cross_k`` / ``cross_v``, as the reference's
        returned cache does).  Returns the cache."""
        cfg = self.config
        enc_out = self._encode(state, enc_frames)
        dims = _attn_dims(cfg)
        b, s_enc, _ = enc_out.shape
        shape = (b, s_enc, dims.num_kv_heads, dims.head_dim)
        for p, c in zip(state["layers"], cache):
            for name, key in (("cross_k", "wk"), ("cross_v", "wv")):
                w = p["cross"][key]
                c[name] = torch.stack([
                    (enc_out @ w[i]).view(shape) for i in range(self.n_periods)
                ]).to(_dtype(cfg))
        return cache

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


def _init_stack(init_one, n: int):
    """``n`` trees from ``init_one()``, their leaves stacked on a new dim 0.

    Each stacked leaf is allocated once and filled tree by tree, so at no
    time does the device hold more than the stack and one tree's weights.
    One tree is its own stack: each leaf gains dim 0 as a view.
    """
    if n == 1:
        return _unsqueezed(init_one())
    stacked = None
    for i in range(n):
        tree = init_one()
        if stacked is None:
            stacked = _stacked_like(tree, n)
        _put(stacked, tree, i)
        del tree
    return stacked


def _unsqueezed(tree):
    if isinstance(tree, dict):
        return {k: _unsqueezed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unsqueezed(v) for v in tree]
    return tree.unsqueeze(0)


def build_model(config: ModelConfig) -> Model:
    return Model(config)
