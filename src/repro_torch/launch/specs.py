"""Input specs: shapes and dtypes with no data, or concrete batches.

Port of ``repro.launch.specs``, with :class:`Spec` records in place of
``jax.ShapeDtypeStruct``.  :func:`input_specs` mirrors what the data
pipeline or the serving frontend delivers for each assigned shape:

  * train / prefill (:func:`train_specs`): {tokens, labels}, with
    ``prefix_embeds`` for a VLM and ``enc_frames`` for the audio
    encoder-decoder (the stubbed modality frontends);
  * decode (:func:`decode_specs`): {tokens (B, 1), pos, cache}, the
    decode step's operands; the cache covers the shape's whole context
    (ring-buffer sized under a sliding window) and is built on the
    ``"meta"`` device, so a full-width one allocates nothing.

:func:`concrete_batch` draws a train / prefill batch as the reference
does, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import Family, ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Spec:
    """Shape and dtype of one input (``jax.ShapeDtypeStruct``'s role)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def _frontend_len(cfg: ModelConfig, seq: int) -> int:
    return min(cfg.frontend.prefix_tokens, seq // 2) if cfg.frontend else 0


def encoder_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if not cfg.encdec:
        return 0
    return max(16, int(shape.seq_len * cfg.encdec.encoder_len_ratio))


def train_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """{prefix_embeds (VLM), enc_frames (audio), tokens, labels}, in the
    reference's order: the stub frontends' inputs in bf16, the tokens and
    labels (global_batch, text length) int32.  A VLM's prefix takes
    :func:`_frontend_len` of the sequence; the text the rest."""
    b, s = shape.global_batch, shape.seq_len
    specs: dict[str, Spec] = {}
    if cfg.family is Family.VLM:
        p = _frontend_len(cfg, s)
        specs["prefix_embeds"] = Spec(
            (b, p, cfg.frontend.embed_dim or cfg.d_model), torch.bfloat16)
        s -= p
    if cfg.encdec:
        specs["enc_frames"] = Spec((b, encoder_len(cfg, shape), cfg.d_model),
                                   torch.bfloat16)
    specs["tokens"] = Spec((b, s), torch.int32)
    specs["labels"] = Spec((b, s), torch.int32)
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 model=None) -> dict[str, Any]:
    """{tokens (B, 1) int32, pos () int32, cache}: the cache a tree of
    :class:`Spec` like :meth:`Model.init_cache`'s (an encoder-decoder's
    cross K/V over the encoder length of a 4096-token shape, as the
    reference sizes it), built on the meta device."""
    model = model or build_model(cfg)
    b, s = shape.global_batch, shape.seq_len
    enc_len = encoder_len(cfg, dataclasses.replace(shape, seq_len=4096))
    cache = model.init_cache(b, s, enc_len=enc_len, device="meta")
    return {
        "tokens": Spec((b, 1), torch.int32),
        "pos": Spec((), torch.int32),
        "cache": tree_map(lambda t: Spec(tuple(t.shape), t.dtype), cache),
    }


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                model=None) -> dict[str, Any]:
    if shape.is_decode:
        return decode_specs(cfg, shape, model)
    return train_specs(cfg, shape)


def concrete_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, *,
                   device=None) -> dict[str, torch.Tensor]:
    """A train / prefill batch on ``device`` (default ``cuda``), drawn as
    the reference's: one ``np.random.default_rng(seed)``, each spec in
    :func:`train_specs`' order, integers uniform over the vocabulary,
    floats standard normal.  A float64 draw reaches bf16 through fp32, the
    route of the reference's cast (``jnp.asarray`` hands it to
    ``ml_dtypes``, which rounds 1 + 2^-8 + 2^-30 to 1 as fp32 then bf16
    does), so the values are the reference's bit for bit."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in train_specs(cfg, shape).items():
        if spec.dtype.is_floating_point:
            arr = rng.standard_normal(spec.shape).astype(np.float32)
        else:
            arr = rng.integers(0, cfg.vocab_size, spec.shape)
        out[name] = torch.from_numpy(arr).to(dev).to(spec.dtype)
    return out


__all__ = ["Spec", "encoder_len", "train_specs", "decode_specs",
           "input_specs", "concrete_batch"]
