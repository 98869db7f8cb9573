"""Config system: model / parallelism / overlap / run configuration.

The port's own copy of ``repro.configs.base`` (the port imports nothing of
the JAX package).  Every architecture's exact public-literature
hyperparameters live in :mod:`repro_torch.configs.registry`; reduced smoke
variants come from :func:`ModelConfig.reduced`.  The overlap backends are
renamed for the port: ``"xla"`` is ``"collective"`` and ``"pallas_dma"`` is
``"dma"``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    HYBRID = "hybrid"  # Mamba + attention interleave (Jamba)
    SSM = "ssm"  # xLSTM
    VLM = "vlm"  # vision frontend stub + LM backbone
    AUDIO = "audio"  # enc-dec with audio frontend stub


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_ff_expert: int = 0  # per-expert FFN width
    dense_residual_ff: int = 0  # Arctic: dense FFN in parallel with MoE
    every_k_layers: int = 1  # MoE replaces FFN every k-th layer (Jamba: 2)
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 = full-rank Q projection (V2-Lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Jamba: attention every k-th layer, Mamba otherwise."""

    attn_every: int = 8  # 1:7 attention:mamba
    attn_offset: int = 4
    mamba: MambaConfig = dataclasses.field(default_factory=MambaConfig)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8  # 7:1 mLSTM:sLSTM
    slstm_offset: int = 7
    proj_factor: float = 2.0
    chunk_size: int = 256  # mLSTM chunkwise-parallel scan chunk


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 24
    # encoder frame count fed by the (stubbed) audio frontend per shape.
    encoder_len_ratio: float = 1.0  # enc frames = ratio * seq_len


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend: input_specs() provides pre-computed
    frame/patch embeddings of this many prefix positions (the one allowed
    carve-out: we implement the LM that consumes them, not the ViT/codec).
    """

    prefix_tokens: int = 256  # VLM: image patches per sample
    embed_dim: int = 0  # 0 -> d_model (projector output dimension)


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """How the paper's technique is applied inside the model."""

    # gspmd_serial: dense projections, no tensor-parallel group used.
    # serial / shard_p2p / ficco_auto / explicit schedule name: FiCCO
    # overlap schedules in the TP linears of an active TPGroup.
    mode: str = "gspmd_serial"
    # collective | dma (copy-engine chunk exchange from repro_torch.kernels)
    backend: str = "collective"
    moe_chunks: int = 0  # 0 -> group size (FiCCO EP dispatch chunking)
    # decode attention over a model-axis time-sharded cache:
    # "gspmd" (implicit partitioning) or "shard_map" (explicit flash-decode
    # with partial-softmax psum combine — see parallel/decode_attn.py).
    decode_attn: str = "gspmd"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # long-context behaviour: None = full causal attention;
    # "sliding_window:<W>" enables banded attention with window W (used by
    # full-attention archs to run the long_500k decode shape).
    sliding_window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    hybrid: Optional[HybridConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[FrontendConfig] = None
    overlap: OverlapConfig = dataclasses.field(default_factory=OverlapConfig)
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    # "nothing" = nothing_saveable (min memory, recomputes fwd incl. its
    # collectives); "dots" = dots_saveable (saves GEMM outputs: no GEMM/
    # AG recompute in backward at higher activation memory).
    remat_policy: str = "nothing"
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model <= 512, <= 4 experts."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        changes: dict = dict(
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=d_model // heads,
            dtype="float32",
            remat=False,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                d_ff_expert=min(self.moe.d_ff_expert or 128, 128),
                dense_residual_ff=(
                    128 if self.moe.dense_residual_ff else 0
                ),
            )
        if self.mla:
            changes["mla"] = dataclasses.replace(
                self.mla,
                kv_lora_rank=64,
                rope_head_dim=32,
                nope_head_dim=d_model // heads,
                v_head_dim=d_model // heads,
            )
            changes["head_dim"] = 0
        if self.hybrid:
            changes["hybrid"] = dataclasses.replace(
                self.hybrid, attn_every=2, attn_offset=1
            )
        if self.xlstm:
            changes["xlstm"] = dataclasses.replace(
                self.xlstm, slstm_every=2, slstm_offset=1, chunk_size=16
            )
        if self.encdec:
            changes["encdec"] = dataclasses.replace(
                self.encdec, encoder_layers=2
            )
        if self.frontend:
            changes["frontend"] = dataclasses.replace(
                self.frontend, prefix_tokens=8
            )
        if self.sliding_window:
            changes["sliding_window"] = 32
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
