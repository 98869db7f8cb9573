"""Input specs of a training batch: shapes and dtypes, no data.

Port of ``repro.launch.specs``' ``train_specs``: what the data pipeline
delivers for one train shape, as :class:`Spec` records in place of
``jax.ShapeDtypeStruct``: {tokens, labels}, with ``prefix_embeds`` for a
VLM and ``enc_frames`` for the audio encoder-decoder (the stubbed
modality frontends).  The hybrid and SSM families are ported for serving
only: their training inputs raise ``NotImplementedError`` until their
training is (ROADMAP queue A, item 13).  ``decode_specs``,
``input_specs`` and ``concrete_batch`` come with the tooling (ROADMAP
A8).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import Family, ModelConfig, ShapeConfig


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
    if cfg.family in (Family.HYBRID, Family.SSM):
        raise NotImplementedError(
            f"{cfg.name}: training of the {cfg.family.value} family is not "
            "ported yet (ROADMAP queue A, item 13)"
        )
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


__all__ = ["Spec", "encoder_len", "train_specs"]
