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
    logits        = model.gather_vocab(logits)  # whole, from a rank's block

On a rank of a group of processes (a ``RankGroup``: every family) the
state holds the rank's blocks by :meth:`Model.rank_specs`, as a
``shard_map`` body over the reference's specs would: the embedding's and
unembedding's vocabulary blocks, and each layer's attention heads, MLP
blocks and experts, the encoder's layers' too, and each Mamba, mLSTM and
sLSTM mixer's block of its inner width.  Where the group divides the sequence (:func:`sequence_cut`:
a VLM's prefix and text joined, an encoder's frames) the rank keeps its
(B, S/g, d) block of the residual stream between layers, as the
reference's ``constrain`` does (Megatron's sequence parallelism); the
logits are the rank's vocabulary block, and :meth:`Model.loss` reduces
over the blocks.  The encoder's output is gathered once for the
decoder's cross-attention, and each cross K/V cache leaf is the rank's
block by the reference's ``cache_leaf_spec``, as is each recurrent
layer's decode state.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint as tcp

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, mamba, mla, moe, xlstm
from repro_torch.models.layers import AttnDims
from repro_torch.parallel import decode_attn
from repro_torch.parallel.collectives import (all_gather, all_reduce,
                                              all_to_all, gather_replicated,
                                              pmax, psum_scatter, rank_block,
                                              replicated)
from repro_torch.parallel.context import get_overlap, overlap_context
from repro_torch.parallel.sharding import (
    MODEL_AXIS,
    P,
    active_group,
    fix_param_specs,
    map_specs,
    tp_group,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# A layer's subtrees that a rank cuts by their specs: the attention's (GQA
# or MLA; an encoder-decoder's cross-attention), the FFN's (an MLP, or the
# MoE experts with their shared and dense-residual MLPs) and the recurrent
# mixer's (Mamba's, the mLSTM's and the sLSTM's, on d_inner; the mLSTM's
# ``w_if`` and the sLSTM's ``r_gates``, ``P(None, None)``, stay whole); in
# the decoder's layers and the encoder's.
RANK_CUT = ("attn", "cross", "ffn", "mixer")
# The top-level leaves a rank cuts by their specs: the embedding's rows
# and the unembedding's columns, by vocabulary.  Every other leaf is whole
# on every rank, as in the reference: the router, the norms (``enc_norm``
# too), MLA's latent projections and ``frontend_proj``.
RANK_CUT_TOP = ("embed", "unembed")
# The top-level stack of layers besides ``layers``: the encoder's, one
# layer's tree stacked over its layers, cut as a layer is (RANK_CUT).
RANK_CUT_STACK = ("encoder",)
# The cache records of a rank's time slice: the self-attention's or
# MLA's (``"time_slice"``) and the cross-attention's (``"cross_slice"``),
# each the slice's first position per period.
SLICE_RECORDS = ("time_slice", "cross_slice")


def sequence_cut(seq_len: int, group) -> bool:
    """Whether a rank of ``group`` (``layers.rank_group()``: a RankGroup of
    more than one rank, or None) holds the residual stream of a
    ``seq_len`` sequence cut by sequence, its (B, S/g, d) block between
    layers: where g divides S, as the reference's ``constrain`` keeps the
    cut only where the model axis divides the dim.  Otherwise (a decode
    step, an odd prompt) the residual is replicated.  The one predicate
    of the per-rank path's layout."""
    return group is not None and seq_len % group.size == 0


# The list that :func:`residual_shapes` yields while it is entered.
_residual_log: Optional[list] = None


@contextlib.contextmanager
def residual_shapes():
    """Within ``with``: the shape of the residual stream after each period
    of every forward, appended to the list it yields (a rank's layout
    between layers, :func:`sequence_cut`)."""
    global _residual_log
    outer, _residual_log = _residual_log, []
    try:
        yield _residual_log
    finally:
        _residual_log = outer


def _norm(params, x, cfg: ModelConfig, seq: bool):
    """A norm; on a sequence block its whole scale and bias are marked
    ``replicated``: each rank's gradient covers only its block."""
    if seq:
        group = layers.rank_group()
        params = {k: replicated(v, group=group) for k, v in params.items()}
    return layers.apply_norm(params, x, cfg.norm)


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
                 enc_out=None, causal: bool = True, seq: bool = False):
    """One layer.  Returns (x, aux): the MoE FFN's aux loss, or None.

    ``causal=False`` is the encoder's bidirectional self-attention (no
    window); ``enc_out`` adds the decoder's cross-attention over it.
    With ``seq`` x is a rank's sequence block (:func:`sequence_cut`), and
    so is the output.
    """
    h = _norm(p["norm1"], x, cfg, seq)
    if spec.mixer == "attn":
        y = layers.attn_apply(
            p["attn"], h, _attn_dims(cfg), rope_theta=cfg.rope_theta,
            positions=positions, window=_window(cfg) if causal else None,
            causal=causal, seq=seq,
        )
    elif spec.mixer == "mla":
        y = mla.mla_apply(p["attn"], h, cfg.num_heads, cfg.mla,
                          positions=positions, window=_window(cfg), seq=seq)
    elif spec.mixer == "mamba":
        y = mamba.mamba_apply(p["mixer"], h, cfg.hybrid.mamba, seq=seq)
    elif spec.mixer == "mlstm":
        y = xlstm.mlstm_apply(p["mixer"], h, cfg.num_heads, cfg.xlstm,
                              seq=seq)
    else:
        y = xlstm.slstm_apply(p["mixer"], h, cfg.xlstm, seq=seq)
    x = x + y
    if enc_out is not None:
        h = _norm(p["norm_cross"], x, cfg, seq)
        x = x + layers.attn_apply(
            p["cross"], h, _attn_dims(cfg), rope_theta=cfg.rope_theta,
            positions=positions, kv_for_cross=enc_out, seq=seq,
        )
    if spec.ffn == "none":
        return x, None
    h = _norm(p["norm2"], x, cfg, seq)
    if spec.ffn == "moe":
        y, aux = moe.moe_apply(p["ffn"], h, cfg.moe, seq=seq)
        return x + y, aux
    return x + layers.mlp_apply(p["ffn"], h, cfg.d_ff, seq=seq), None


def _period_apply(period, pattern, cfg: ModelConfig, x, positions,
                  enc_out=None, seq: bool = False):
    """The layers of one period (period[j] holds slot j's parameters).
    Returns (x, the period's summed aux loss or None)."""
    aux = None
    for p, spec in zip(period, pattern):
        x, a = _layer_apply(p, spec, cfg, x, positions, enc_out=enc_out,
                            seq=seq)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _remat_period(period, pattern, cfg: ModelConfig, x, positions,
                  enc_out, seq, overlap, group):
    """A period under recomputation.  The backward reruns it after the
    forward's overlap context and TP group have been left, so it enters
    the ones the forward ran in.  A recurrent mixer builds its state from
    zero in every call, so the rerun reproduces the forward bit for
    bit."""
    with overlap_context(overlap), tp_group(group):
        return _period_apply(period, pattern, cfg, x, positions, enc_out,
                             seq)


def _remat_enc_layer(p, cfg: ModelConfig, x, positions, seq, overlap,
                     group):
    """An encoder layer under recomputation (as :func:`_remat_period`)."""
    with overlap_context(overlap), tp_group(group):
        return _layer_apply(p, _ENC_SPEC, cfg, x, positions, causal=False,
                            seq=seq)[0]


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
        m = cfg.mla
        held = {decode_attn.cache_positions(shape) for shape in (
            (*lead, batch, cache_len, m.kv_lora_rank),
            (*lead, batch, cache_len, 1, m.rope_head_dim))}
        if len(held) > 1:
            raise NotImplementedError(
                f"MLA's cache of {cache_len} positions on a RankGroup: the "
                "reference's rule cuts its latent and rope key apart")
        (here,) = held
        return _time_slice(mla.mla_init_cache(
            batch, cache_len, m, dt, device, lead=lead, positions=here),
            cache_len, here, lead, device)
    if spec.mixer in RECURRENT:
        # A rank holds its block of each leaf by the reference's rule
        # (d_inner, or the mLSTM's key dim, where it cuts them).
        return {key: torch.full(decode_attn.cache_block(leaf.shape),
                                _state_start(key), dtype=leaf.dtype,
                                device=device)
                for key, leaf in _recurrent_cache(spec, cfg, batch, dt,
                                                  lead).items()}
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    s = min(cache_len, cfg.sliding_window or cache_len)
    # A rank of a group of processes holds its block by the reference's
    # rule: its time slice where the rule cuts the time axis.
    here = decode_attn.cache_positions((*lead, batch, s, kv, hd))
    shape = (*lead, batch, here, kv, hd)
    return _time_slice({
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }, s, here, lead, device)


def _recurrent_cache(spec: LayerSpec, cfg: ModelConfig, batch: int, dt,
                     lead: tuple) -> dict:
    """A recurrent layer's whole decode state, on the meta device."""
    if spec.mixer == "mamba":
        return mamba.mamba_init_cache(batch, cfg.d_model, cfg.hybrid.mamba,
                                      dt, "meta", lead=lead)
    if spec.mixer == "mlstm":
        return xlstm.mlstm_init_cache(batch, cfg.d_model, cfg.num_heads,
                                      cfg.xlstm, "meta", lead=lead)
    return xlstm.slstm_init_cache(batch, cfg.d_model, cfg.xlstm, "meta",
                                  lead=lead)


def _time_slice(cache: dict, s: int, here: int, lead: tuple, device,
                key: str = "time_slice") -> dict:
    """Where a rank holds ``here`` of a cache's ``s`` positions, the
    record that the decode reads (``key``, one of :data:`SLICE_RECORDS`):
    the slice's first position, per period."""
    if here < s:
        cache[key] = torch.full(lead, active_group().rank * here,
                                device=device)
    return cache


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
        x = x + layers.cross_attn_decode(
            p["cross"], h, cache["cross_k"], cache["cross_v"],
            _attn_dims(cfg), sliced="cross_slice" in cache)
    if spec.ffn == "none":
        return x, cache
    h = layers.apply_norm(p["norm2"], x, cfg.norm)
    if spec.ffn == "moe":
        y, _ = moe.moe_apply(p["ffn"], h, cfg.moe)
    else:
        y = layers.mlp_apply(p["ffn"], h, cfg.d_ff)
    return x + y, cache


# The recurrent mixers, whose decode state starts at zero in every leaf
# but the running maxima ``m``.
RECURRENT = frozenset({"mamba", "mlstm", "slstm"})


def _state_start(key: str) -> float:
    """A recurrent decode state leaf's start value."""
    return xlstm.M_START if key == "m" else 0.0


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
                leaf.fill_(_state_start(key))


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
        self._rank_specs: dict[int, dict] = {}

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

    def rank_specs(self, size: int) -> dict:
        """The specs by which a rank of a group of ``size`` processes holds
        the state (:func:`~repro_torch.parallel.sharding.shard_params`):
        :meth:`param_specs` with the leaves under a layer's
        :data:`RANK_CUT` keys (the decoder's and, :data:`RANK_CUT_STACK`,
        the encoder's) and the :data:`RANK_CUT_TOP` leaves (the
        vocabulary's) kept and every other leaf whole, fixed by
        :func:`~repro_torch.parallel.sharding.fix_param_specs` on the
        whole shapes on ``Mesh(("model",), (size,))``, which drops a cut
        that ``size`` does not divide, as the reference's ``constrain``
        does."""
        from repro_torch.launch.mesh import Mesh

        cached = self._rank_specs.get(size)
        if cached is not None:
            return cached
        specs = self.param_specs()

        def whole(tree):
            return map_specs(lambda sp: P(), tree)

        def layer(slot):
            return {k: v if k in RANK_CUT else whole(v)
                    for k, v in slot.items()}

        cut = {k: v if k in RANK_CUT_TOP else
               layer(v) if k in RANK_CUT_STACK else whole(v)
               for k, v in specs.items() if k != "layers"}
        cut["layers"] = [layer(slot) for slot in specs["layers"]]
        self._rank_specs[size] = fix_param_specs(
            cut, self.init(device="meta"), Mesh((MODEL_AXIS,), (size,)))
        return self._rank_specs[size]

    # ---- forward ----------------------------------------------------------
    def _encode(self, state, enc_frames):
        """The encoder over (B, S_enc, d) frames -> its normed output.

        Under ``remat`` each layer is recomputed in the backward, as the
        reference's ``jax.checkpoint`` around its layer (which saves
        nothing, whatever the config's policy).

        On a rank of a ``RankGroup`` each layer runs on the rank's heads
        and MLP blocks; where g divides S_enc (:func:`sequence_cut`) the
        rank holds its (B, S_enc/g, d) block between layers and
        ``enc_norm`` applies to it, as the reference's ``constrain`` ends
        every layer, the encoder's too.  The output comes back whole on
        every rank as the decoder's cross-attention operand
        (:func:`~repro_torch.models.layers.rank_input`): one all-gather
        along the sequence per forward, whose transpose sums the ranks'
        partial cotangents, or, replicated, marked ``replicated``; so the
        cross-attention marks nothing again."""
        cfg = self.config
        x = enc_frames.to(_dtype(cfg))
        b, s = x.shape[:2]
        group = layers.rank_group()
        seq = sequence_cut(s, group)
        if seq:
            x = rank_block(x, 1, group=group)
        positions = torch.arange(s, device=x.device).expand(b, s)
        remat = self._remat is not None and torch.is_grad_enabled()
        ctx = (get_overlap(), active_group()) if remat else ()
        for p in _unstack(state["encoder"], cfg.encdec.encoder_layers):
            if remat:
                x = tcp.checkpoint(
                    _remat_enc_layer, p, cfg, x, positions, seq, *ctx,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, _ = _layer_apply(p, _ENC_SPEC, cfg, x, positions,
                                    causal=False, seq=seq)
            if _residual_log is not None:
                _residual_log.append(tuple(x.shape))
        x = _norm(state["enc_norm"], x, cfg, seq)
        return x if group is None else layers.rank_input(x, group, seq)

    def forward(self, state, batch: dict):
        """batch keys: tokens (B, S); with the stub frontends also
        prefix_embeds (B, P, embed_dim) (VLM) or enc_frames (B, S_enc, d)
        (audio).  Returns (logits over the text tokens, aux_loss): aux is
        the MoE layers' summed load-balance and z losses (0 without).

        On a rank of a ``RankGroup`` the logits are the rank's (B, S, V/g)
        vocabulary block where the unembedding is cut, as a ``shard_map``
        body's ``P(None, None, "model")`` output (:meth:`gather_vocab`
        joins them), and between layers the rank holds its sequence block
        of the residual stream where g divides its length
        (:func:`sequence_cut`): a VLM's (B, (P + S)/g, d) block of the
        prefix and the text joined, as the reference runs its layers on
        the whole P + S sequence; the encoder's likewise
        (:meth:`_encode`)."""
        cfg = self.config
        tokens = batch["tokens"]
        group = layers.rank_group()
        prefix = cfg.frontend is not None and "prefix_embeds" in batch
        n_text = tokens.shape[1]
        s = n_text + (batch["prefix_embeds"].shape[1] if prefix else 0)
        seq = sequence_cut(s, group)
        if prefix:
            x = self._embed_prefixed(state, tokens, batch["prefix_embeds"],
                                     seq)
        else:
            x = self._embed(state, tokens, seq)
        enc_out = (self._encode(state, batch["enc_frames"])
                   if self.is_encdec else None)
        b = x.shape[0]
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
                    enc_out, seq, *ctx, use_reentrant=False,
                    preserve_rng_state=False, **self._remat)
            else:
                x, a = _period_apply(period, self.pattern, cfg, x, positions,
                                     enc_out, seq)
            if a is not None:
                aux = aux + a
            if _residual_log is not None:
                _residual_log.append(tuple(x.shape))
        x = _norm(state["final_norm"], x, cfg, seq)
        # The logits cover the text segment (the last n_text positions).
        return self._unembed(state, x, seq, n_text if prefix else None), aux

    def _embed(self, state, tokens, seq: bool, lead: int = 0):
        """The embedding lookup.  On a rank holding its row block of the
        vocabulary, the tokens in its rows are looked up and the others
        are zeros; the group's sum (a reduce-scatter along the sequence
        where it is cut, else an ``all_reduce``) has exactly one nonzero
        term per token, so it is the lookup exactly, in any dtype.  A whole
        embedding is looked up alike on every rank, cut to the rank's
        sequence block where it is cut.  ``lead`` zero rows go before the
        tokens' (a VLM's prefix positions, :meth:`_embed_prefixed`)."""
        cfg = self.config
        w = state["embed"]
        group = layers.rank_group()
        if group is None or w.shape[0] == cfg.vocab_size:
            x = _lead_zeros(w[tokens].to(_dtype(cfg)), lead)
            return rank_block(x, 1, group=group) if seq else x
        n = w.shape[0]
        local = tokens - group.rank * n
        mine = (local >= 0) & (local < n)
        x = _lead_zeros(torch.where(mine[..., None], w[local.clamp(0, n - 1)],
                                    0).to(_dtype(cfg)), lead)
        if seq:
            return psum_scatter(x, 1, group=group)
        return all_reduce(x, group=group)

    def _embed_prefixed(self, state, tokens, prefix_embeds, seq: bool):
        """A VLM's input: the stub frontend's (B, P, embed_dim) patch
        embeddings projected by ``frontend_proj`` and joined before the
        text's embedding, (B, P + S, d).  On a rank with ``seq`` the rank's
        block of the joined sequence: the text's lookup behind P zero rows
        (:meth:`_embed`), plus the rank's rows of the prefix (zeros where
        they are text) through the whole ``frontend_proj``, marked
        ``replicated`` (each rank's gradient covers its rows); the two
        have no nonzero row in common, so the sum is the join exactly."""
        cfg = self.config
        pe = prefix_embeds.to(_dtype(cfg))
        w = state.get("frontend_proj")
        if not seq:
            if w is not None:
                pe = pe @ w
            return torch.cat([pe, self._embed(state, tokens, False)], dim=1)
        group = layers.rank_group()
        rows = rank_block(torch.cat([pe, pe.new_zeros(
            (*tokens.shape, pe.shape[-1]))], dim=1), 1, group=group)
        if w is not None:
            rows = rows @ replicated(w, group=group)
        return self._embed(state, tokens, True, lead=pe.shape[1]) + rows

    def _unembed(self, state, x, seq: bool = False, text: int | None = None):
        """The logits of the final-normed ``x`` (of its last ``text``
        positions, where given: a VLM's text segment).  On a rank holding
        its column block of the unembedding (or, tied, its row block of
        the embedding) they are its vocabulary block, from every rank's
        sequence blocks gathered (``seq``; the text segment is taken from
        the gathered sequence) or the replicated ``x``."""
        w = (
            state["embed"].T
            if self.config.tie_embeddings
            else state["unembed"]
        )
        group = layers.rank_group()
        if group is not None:
            if w.shape[1] != self.config.vocab_size:
                x = layers.rank_input(x, group, seq)
            elif seq:  # every rank computes the whole logits alike
                x = gather_replicated(x, 1, group=group)
        if text is not None:
            x = x[:, -text:]
        return x @ w.to(x.dtype)

    def gather_vocab(self, logits):
        """Whole logits from a rank's vocabulary block (one all-gather, the
        blocks in rank order), for callers that read every token's
        logits; ``logits`` as they are off a ``RankGroup`` or where the
        unembedding is whole."""
        group = layers.rank_group()
        if group is None or logits.shape[-1] == self.config.vocab_size:
            return logits
        return all_gather(logits, tiled=True, axis=-1, group=group)

    def loss(self, state, batch: dict):
        """Vocab-wise fp32 cross entropy, as the reference's ``Model.loss``.

        batch keys: tokens, labels (B, S).  Returns (ce + aux, {"ce",
        "aux"}); aux is 0 for the dense family.  The max is detached and
        the reductions run over the vocab dim in the reference's order:
        logsumexp per position, then the mean over (B, S - 1).  The gold
        logit is a gather, which equals the reference's masked sum over
        the vocab exactly (one nonzero term).  On a rank holding its
        vocabulary block of the logits the reductions cross the group
        without gathering them, as GSPMD partitions the reference's: the
        max by ``pmax``, the sum of exponentials and the gold logit (the
        rank's masked pick, zero where the label is another rank's) by
        ``all_reduce``.
        """
        logits, aux = self.forward(state, batch)
        labels = batch["labels"]
        lg = logits[:, :-1].float()
        tg = labels[:, 1:].long()
        group = layers.rank_group()
        n = lg.shape[-1]
        if group is None or n == self.config.vocab_size:
            m = lg.amax(dim=-1, keepdim=True).detach()
            logz = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
            gold = lg.gather(-1, tg[..., None])[..., 0]
        else:
            m = pmax(lg.detach().amax(dim=-1, keepdim=True), group=group)
            logz = torch.log(all_reduce(torch.exp(lg - m).sum(dim=-1),
                                        group=group)) + m[..., 0]
            local = tg - group.rank * n
            mine = (local >= 0) & (local < n)
            pick = lg.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
            gold = all_reduce(torch.where(mine, pick, 0.0), group=group)
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
        :meth:`prefill_cross`).  On a rank of a ``RankGroup`` each leaf
        is the rank's block by the reference's ``cache_leaf_spec``
        (:func:`~repro_torch.parallel.decode_attn.cache_positions`),
        whatever the decode attention: an attention layer's K and V, and
        MLA's latent and rope key, hold the rank's time slice where the
        rule cuts the time axis (1024 positions or more, divisible by g),
        and a ``"time_slice"`` leaf, the slice's first position, records
        it; likewise the cross K and V, the rank's slice of the encoder's
        ``enc_len`` positions where the rule cuts them (1024 or more,
        divisible by g), recorded by ``"cross_slice"``; and a recurrent
        layer's state, the rank's block of d_inner (the mLSTM's of its
        key dim) where the rule cuts it (1024 or more, divisible by g),
        else whole on every rank."""
        cfg = self.config
        dev = resolve_device(device)
        lead = (self.n_periods,)
        caches = [
            _layer_init_cache(spec, cfg, batch, cache_len, dev, lead)
            for spec in self.pattern
        ]
        if self.is_encdec:
            tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
            here = decode_attn.cache_positions((*lead, batch, enc_len, *tail))
            for c in caches:
                for name in ("cross_k", "cross_v"):
                    c[name] = torch.zeros((*lead, batch, here, *tail),
                                          dtype=_dtype(cfg), device=dev)
                _time_slice(c, enc_len, here, lead, dev, "cross_slice")
        return caches

    def prefill_cross(self, state, cache, enc_frames):
        """Encoder-decoder: run the encoder over (B, S_enc, d) frames and
        put each decoder layer's cross K and V of its output into the
        cache (replacing ``cross_k`` / ``cross_v``, as the reference's
        returned cache does).  Returns the cache.

        On a rank each layer's ``wk`` and ``wv`` are column blocks (kv/g
        heads, or a share of one where g does not divide kv), so each
        slot's K and V columns of every period are joined and exchanged
        once: an all-gather of the column blocks where the rule keeps the
        leaf whole, an all-to-all from columns to time where it cuts the
        time axis (rank s sends each rank its columns of that rank's time
        slice), as the ``gspmd`` decode exchanges cache slices."""
        cfg = self.config
        enc_out = self._encode(state, enc_frames)
        dims = _attn_dims(cfg)
        width = dims.num_kv_heads * dims.head_dim
        group = layers.rank_group()
        for p, c in zip(state["layers"], cache):
            wk, wv = p["cross"]["wk"], p["cross"]["wv"]
            cols = torch.stack([torch.stack([enc_out @ wk[i], enc_out @ wv[i]],
                                            -2)
                                for i in range(self.n_periods)])
            # cols: (periods, B, S_enc, 2, columns held here)
            sliced = "cross_slice" in c
            if group is not None and wk.shape[-1] != width:
                if sliced:  # [s]: rank s's columns of this rank's slice
                    cols = all_to_all(cols.unflatten(2, (group.size, -1))
                                      .movedim(2, 0).contiguous(),
                                      group=group)
                else:  # [s]: rank s's columns
                    cols = all_gather(cols.contiguous(), group=group)
                cols = cols.movedim(0, -2).flatten(-2)
            elif sliced:  # whole columns: the rank's time slice of them
                here = c["cross_k"].shape[2]
                cols = cols.narrow(2, group.rank * here, here)
            k, v = cols.unflatten(-1, (dims.num_kv_heads,
                                       dims.head_dim)).unbind(-3)
            c["cross_k"], c["cross_v"] = k.to(_dtype(cfg)), v.to(_dtype(cfg))
        return cache

    def decode_step(self, state, cache, tokens, pos: int):
        """tokens: (B, 1) int; pos: position. -> (logits, cache).

        The cache is updated in place and returned.  On a rank the
        residual is replicated (one position) and the logits are the
        rank's vocabulary block, as :meth:`forward`'s.
        """
        cfg = self.config
        x = self._embed(state, tokens, seq=False)
        for i in range(self.n_periods):
            for j, spec in enumerate(self.pattern):
                x, _ = _layer_decode(
                    _index(state["layers"][j], i), spec, cfg, x,
                    _index(cache[j], i), pos,
                )
        x = layers.apply_norm(state["final_norm"], x, cfg.norm)
        return self._unembed(state, x), cache


def _lead_zeros(x, lead: int):
    """``x`` (B, S, d) behind ``lead`` rows of zeros along the sequence."""
    if not lead:
        return x
    return torch.cat([x.new_zeros((x.shape[0], lead, x.shape[2])), x], 1)


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
