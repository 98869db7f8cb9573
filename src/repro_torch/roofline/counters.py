"""Analytic FLOP and HBM-byte counters per architecture component.

Port of ``repro.roofline.counters``, on the port's ``layer_pattern``: the
same component formulas (window-aware attention, MLA, MoE active-expert
accounting, the Mamba, mLSTM and sLSTM recurrences), the same sums in the
same order, so every count equals the reference's bit for bit.  The
reference needs them because XLA's ``cost_analysis`` counts a while
loop's body once; the port uses them as the work a step must do, the
bound its measured times stand beside.  :func:`param_bytes` takes the
parameter count from :func:`repro_torch.roofline.analysis.count_params`
at two bytes each, as the reference does whatever the leaves' dtypes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.mamba import mamba_dims
from repro_torch.models.model import layer_pattern
from repro_torch.roofline.analysis import count_params


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o):
        return Costs(self.flops + o.flops, self.bytes + o.bytes)

    def __mul__(self, k: float):
        return Costs(self.flops * k, self.bytes * k)

    __rmul__ = __mul__


def _gemm(m, n, k, b=2) -> Costs:
    return Costs(2.0 * m * n * k, float(m * k + k * n + m * n) * b)


def _attn_costs(cfg: ModelConfig, b, s, ctx, *, decode: bool) -> Costs:
    h, kv, hd, d = (
        cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    )
    c = _gemm(b * s, h * hd, d)  # q
    c += 2 * _gemm(b * s, kv * hd, d)  # k, v
    c += _gemm(b * s, d, h * hd)  # o
    # scores + AV; training causal halves the average context.
    eff_ctx = ctx if decode else ctx * 0.5
    flops = 2.0 * b * h * s * eff_ctx * hd * 2
    bytes_ = 2.0 * b * s * (h + 2 * kv) * hd * 2  # q/k/v streamed
    if decode:
        bytes_ += b * ctx * 2 * kv * hd * 2  # cache read
    return c + Costs(flops, bytes_)


def _mla_costs(cfg: ModelConfig, b, s, ctx, *, decode: bool) -> Costs:
    m = cfg.mla
    h, d = cfg.num_heads, cfg.d_model
    qk = m.nope_head_dim + m.rope_head_dim
    c = _gemm(b * s, h * qk, d)  # q
    c += _gemm(b * s, m.kv_lora_rank, d)  # down
    c += _gemm(b * s, m.rope_head_dim, d)
    exp_s = ctx if decode else s  # decode re-expands the latent cache
    c += _gemm(b * exp_s, h * m.nope_head_dim, m.kv_lora_rank)
    c += _gemm(b * exp_s, h * m.v_head_dim, m.kv_lora_rank)
    c += _gemm(b * s, d, h * m.v_head_dim)
    eff_ctx = ctx if decode else ctx * 0.5
    c += Costs(
        2.0 * b * h * s * eff_ctx * (qk + m.v_head_dim),
        b * ctx * (m.kv_lora_rank + m.rope_head_dim) * 2 if decode else 0,
    )
    return c


def _gated_mlp(d, ff, tokens) -> Costs:
    return 3 * _gemm(tokens, ff, d)  # up + gate + down (same cost each)


def _moe_costs(cfg: ModelConfig, tokens) -> Costs:
    mo, d = cfg.moe, cfg.d_model
    c = _gemm(tokens, mo.num_experts, d)  # router
    c += mo.top_k * _gated_mlp(d, mo.d_ff_expert, tokens)
    if mo.num_shared_experts:
        c += _gated_mlp(d, mo.d_ff_expert * mo.num_shared_experts, tokens)
    if mo.dense_residual_ff:
        c += _gated_mlp(d, mo.dense_residual_ff, tokens)
    # dispatch/combine data movement
    c += Costs(0.0, 4.0 * tokens * d * 2)
    return c


def _mamba_costs(cfg: ModelConfig, b, s, *, decode: bool) -> Costs:
    mc = cfg.hybrid.mamba
    d = cfg.d_model
    di, dtr = mamba_dims(d, mc)
    t = b * s
    c = _gemm(t, 2 * di, d)  # in proj
    c += Costs(2.0 * t * di * mc.d_conv, t * di * 2)  # conv
    c += _gemm(t, dtr + 2 * mc.d_state, di)
    c += _gemm(t, di, dtr)
    # selective scan: ~6 flops per (token, channel, state)
    c += Costs(6.0 * t * di * mc.d_state, 4.0 * t * di * 2)
    c += _gemm(t, d, di)  # out
    if decode:
        c += Costs(0.0, b * di * mc.d_state * 4)  # state read/write
    return c


def _mlstm_costs(cfg: ModelConfig, b, s, *, decode: bool) -> Costs:
    di = int(cfg.xlstm.proj_factor * cfg.d_model)
    h = cfg.num_heads
    hd = di // h
    t = b * s
    c = _gemm(t, 2 * di, cfg.d_model)
    c += 3 * _gemm(t, di, di)
    # per step: outer product + state update + readout: ~6 * hd^2 per head
    c += Costs(6.0 * t * h * hd * hd, 2.0 * t * di * 2)
    c += _gemm(t, cfg.d_model, di)
    if decode:
        c += Costs(0.0, b * h * hd * hd * 4 * 2)  # matrix state r/w
    return c


def _slstm_costs(cfg: ModelConfig, b, s, *, decode: bool) -> Costs:
    di = int(cfg.xlstm.proj_factor * cfg.d_model)
    t = b * s
    c = _gemm(t, di, cfg.d_model)
    c += _gemm(t, 4 * di, di)  # input gates
    c += _gemm(t, 4 * di, di)  # recurrent gates (per step, dense R)
    c += Costs(10.0 * t * di, 2.0 * t * di * 2)
    c += _gemm(t, cfg.d_model, di)
    return c


def forward_costs(
    cfg: ModelConfig, b: int, s: int, *, ctx: int | None = None,
    decode: bool = False,
) -> Costs:
    """One forward pass over ``b`` sequences of ``s`` new tokens with
    attention context ``ctx`` (defaults: s for train, window-clamped)."""
    ctx = ctx if ctx is not None else s
    if cfg.sliding_window:
        ctx = min(ctx, cfg.sliding_window)
    pattern = layer_pattern(cfg)
    n_periods = cfg.num_layers // len(pattern)
    tokens = b * s
    per_period = Costs()
    for spec in pattern:
        if spec.mixer == "attn":
            per_period += _attn_costs(cfg, b, s, ctx, decode=decode)
        elif spec.mixer == "mla":
            per_period += _mla_costs(cfg, b, s, ctx, decode=decode)
        elif spec.mixer == "mamba":
            per_period += _mamba_costs(cfg, b, s, decode=decode)
        elif spec.mixer == "mlstm":
            per_period += _mlstm_costs(cfg, b, s, decode=decode)
        else:
            per_period += _slstm_costs(cfg, b, s, decode=decode)
        if spec.ffn == "mlp":
            per_period += _gated_mlp(cfg.d_model, cfg.d_ff, tokens)
        elif spec.ffn == "moe":
            per_period += _moe_costs(cfg, tokens)
        # norms / residuals
        per_period += Costs(8.0 * tokens * cfg.d_model,
                            6.0 * tokens * cfg.d_model * 2)
    total = n_periods * per_period
    # embed + unembed
    total += Costs(0.0, tokens * cfg.d_model * 2)
    total += _gemm(tokens, cfg.vocab_size, cfg.d_model)
    if cfg.encdec and not decode:
        enc_tokens = b * s  # encoder frames ~ seq_len (stub ratio 1.0)
        enc = _attn_costs(cfg, b, s, s, decode=False) + _gated_mlp(
            cfg.d_model, cfg.d_ff, enc_tokens
        )
        total += cfg.encdec.encoder_layers * enc
        # cross attention per decoder layer
        total += cfg.num_layers * _attn_costs(cfg, b, s, s, decode=False)
    if cfg.encdec and decode:
        # cross-attention reads of the cached encoder K/V
        total += cfg.num_layers * Costs(
            2.0 * b * cfg.num_heads * ctx * cfg.resolved_head_dim * 2,
            b * ctx * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2,
        )
    return total


def param_bytes(cfg: ModelConfig) -> float:
    return count_params(cfg) * 2  # bf16


def step_costs(cfg: ModelConfig, shape: ShapeConfig, kind: str) -> Costs:
    """Total analytic costs of one dry-run step function."""
    b, s = shape.global_batch, shape.seq_len
    pb = param_bytes(cfg)
    if kind == "train":
        fwd = forward_costs(cfg, b, s)
        mult = 3.0 + (1.0 if cfg.remat else 0.0)  # fwd + bwd(2x) + remat
        c = mult * fwd
        # optimizer: read p/m/v + grads, write p/m/v (mixed precision)
        c += Costs(10.0 * pb / 2, 8.0 * pb)
        c += Costs(0.0, 3.0 * pb)  # grads write + weight reads beyond acts
        return c
    if kind == "prefill":
        c = forward_costs(cfg, b, s)
        return c + Costs(0.0, pb)
    # decode: one token, context = seq_len
    c = forward_costs(cfg, b, 1, ctx=s, decode=True)
    return c + Costs(0.0, pb)  # full weight read per step


__all__ = ["Costs", "forward_costs", "param_bytes", "step_costs"]
