"""Input specs of a training batch: shapes and dtypes, no data.

Port of ``repro.launch.specs`` for the dense family: ``train_specs``
describes what the data pipeline delivers for one train shape, as
:class:`Spec` records in place of ``jax.ShapeDtypeStruct``.  The stub
modality frontends (a VLM's ``prefix_embeds``, an encoder-decoder's
``enc_frames``) and the non-dense families raise ``NotImplementedError``
until their models are ported (ROADMAP A5, A7); ``decode_specs``,
``input_specs`` and ``concrete_batch`` come with the tooling (ROADMAP A8).
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
    """{tokens, labels}: (global_batch, seq_len) int32 each."""
    if cfg.family is not Family.DENSE or cfg.moe or cfg.mla or (
        cfg.encdec is not None or cfg.frontend is not None
    ):
        item = (
            "A11: MoE training" if cfg.family is Family.MOE or cfg.moe
            else "queue A, item 7"
        )
        raise NotImplementedError(
            f"{cfg.name}: training inputs of the {cfg.family.value} family "
            f"are not ported yet (ROADMAP {item})"
        )
    b, s = shape.global_batch, shape.seq_len
    return {
        "tokens": Spec((b, s), torch.int32),
        "labels": Spec((b, s), torch.int32),
    }


__all__ = ["Spec", "encoder_len", "train_specs"]
