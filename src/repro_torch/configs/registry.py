"""Architecture registry: the 10 assigned configs (+ aliases).

Every entry cites its source; exact hyperparameters from the assignment.
"""

from __future__ import annotations

from repro_torch.configs.base import (
    EncDecConfig,
    Family,
    FrontendConfig,
    HybridConfig,
    MambaConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    XLSTMConfig,
)


def seamless_m4t_large_v2() -> ModelConfig:
    # [arXiv:2308.11596] SeamlessM4T v2-large: 24L speech encoder (stubbed
    # conformer frontend -> frame embeddings) + 24L text decoder.
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family=Family.AUDIO,
        num_layers=24,  # decoder; encoder layers below
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        # true vocab 256206, padded to a multiple of 256 (Megatron-style)
        # so the unembed/CE shard evenly over the 16-way model axis —
        # unpadded it forces replicated fp32 logits (~67 GB/device).
        vocab_size=256256,
        norm="layernorm",
        encdec=EncDecConfig(encoder_layers=24, encoder_len_ratio=1.0),
        frontend=FrontendConfig(prefix_tokens=0, embed_dim=0),
        citation="arXiv:2308.11596",
    )


def olmo_1b() -> ModelConfig:
    # [arXiv:2402.00838] OLMo-1B: non-parametric LayerNorm, tied embeddings.
    return ModelConfig(
        name="olmo-1b",
        family=Family.DENSE,
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        norm="nonparametric_ln",
        tie_embeddings=True,
        citation="arXiv:2402.00838",
    )


def deepseek_v2_lite_16b() -> ModelConfig:
    # [arXiv:2405.04434] DeepSeek-V2-Lite: MLA (kv_lora 512, rope head 64),
    # 64 routed experts top-6 + 2 shared, expert FFN 1408.
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family=Family.MOE,
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        mla=MLAConfig(
            kv_lora_rank=512, rope_head_dim=64,
            nope_head_dim=128, v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=64, top_k=6, num_shared_experts=2,
            d_ff_expert=1408,
        ),
        citation="arXiv:2405.04434",
    )


def arctic_480b() -> ModelConfig:
    # [hf:Snowflake/snowflake-arctic-base] 128 experts top-2 in parallel
    # with a dense residual FFN (dense-MoE hybrid).
    return ModelConfig(
        name="arctic-480b",
        family=Family.MOE,
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        moe=MoEConfig(
            num_experts=128, top_k=2, d_ff_expert=4864,
            dense_residual_ff=4864,
        ),
        citation="hf:Snowflake/snowflake-arctic-base",
    )


def jamba_1_5_large_398b() -> ModelConfig:
    # [arXiv:2403.19887] Jamba: Mamba+attention 1:7, MoE (16e top-2) on
    # every other layer.
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family=Family.HYBRID,
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        hybrid=HybridConfig(
            attn_every=8, attn_offset=4,
            mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        ),
        moe=MoEConfig(
            num_experts=16, top_k=2, d_ff_expert=24576, every_k_layers=2
        ),
        citation="arXiv:2403.19887",
    )


def tinyllama_1_1b() -> ModelConfig:
    # [arXiv:2401.02385] TinyLlama: llama-2 architecture, GQA kv=4.
    return ModelConfig(
        name="tinyllama-1.1b",
        family=Family.DENSE,
        num_layers=22,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        d_ff=5632,
        vocab_size=32000,
        citation="arXiv:2401.02385",
    )


def smollm_360m() -> ModelConfig:
    # [hf:HuggingFaceTB/SmolLM-360M] llama-arch small; 15 heads, GQA kv=5.
    return ModelConfig(
        name="smollm-360m",
        family=Family.DENSE,
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        tie_embeddings=True,
        citation="hf:HuggingFaceTB/SmolLM-135M",
    )


def yi_9b() -> ModelConfig:
    # [arXiv:2403.04652] Yi-9B: llama arch with GQA kv=4.
    return ModelConfig(
        name="yi-9b",
        family=Family.DENSE,
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        citation="arXiv:2403.04652",
    )


def internvl2_76b() -> ModelConfig:
    # [arXiv:2404.16821] InternVL2-Llama3-76B backbone (the LM that consumes
    # InternViT patch embeddings; ViT stubbed per the carve-out, projector
    # from ViT width 3200 is real).
    return ModelConfig(
        name="internvl2-76b",
        family=Family.VLM,
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        frontend=FrontendConfig(prefix_tokens=256, embed_dim=3200),
        citation="arXiv:2404.16821",
    )


def xlstm_1_3b() -> ModelConfig:
    # [arXiv:2405.04517] xLSTM-1.3B: sLSTM + mLSTM blocks (7:1), no FFN.
    return ModelConfig(
        name="xlstm-1.3b",
        family=Family.SSM,
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        xlstm=XLSTMConfig(slstm_every=8, slstm_offset=7, proj_factor=2.0),
        citation="arXiv:2405.04517",
    )


ARCHS = {
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "olmo-1b": olmo_1b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "arctic-480b": arctic_480b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "smollm-360m": smollm_360m,
    "yi-9b": yi_9b,
    "internvl2-76b": internvl2_76b,
    "xlstm-1.3b": xlstm_1_3b,
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]()
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
