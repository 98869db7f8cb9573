"""Mamba selective SSM block (Jamba's sequence mixer, arXiv:2403.19887).

Port of ``repro.models.mamba``.  The recurrence h_t = exp(dt_t * A)
h_{t-1} + dt_t * B_t x_t runs as a loop over time on one (B, D, N) fp32
state, the reference's ``lax.scan`` step for step: O(1) memory per step,
exact.  The block holds no data-dependent collective, so FiCCO does not
apply to it; its projections are plain products.

The casts are the reference's: the projections, the causal convolution
and ``softplus(dt)`` run in the model's dtype, the scan in fp32, and its
output returns to the model's dtype before the gate.  ``a_log`` and
``d_skip`` are fp32 leaves whatever the model's dtype
(:data:`FP32_LEAVES`).

Decode carries (conv window, ssm state): O(1) per token.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MambaConfig
from repro_torch.models import layers
from repro_torch.parallel.sharding import MODEL_AXIS, P

# The leaves the reference keeps in fp32 whatever the model's dtype.
FP32_LEAVES = frozenset({"a_log", "d_skip"})


def mamba_dims(d_model: int, cfg: MambaConfig):
    d_inner = cfg.expand * d_model
    dt_rank = cfg.dt_rank or max(1, math.ceil(d_model / 16))
    return d_inner, dt_rank


def mamba_init(gen, d_model: int, cfg: MambaConfig, dtype, device):
    d_inner, dt_rank = mamba_dims(d_model, cfg)
    a = torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                     device=device).expand(d_inner, cfg.d_state)
    return {
        "w_in": layers.dense_init(gen, d_model, 2 * d_inner, dtype, device),
        "conv_w": (torch.randn((cfg.d_conv, d_inner), generator=gen,
                               device=device) * 0.1).to(dtype),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "w_x": layers.dense_init(gen, d_inner, dt_rank + 2 * cfg.d_state,
                                 dtype, device),
        "w_dt": layers.dense_init(gen, dt_rank, d_inner, dtype, device),
        "dt_bias": torch.zeros((d_inner,), dtype=dtype, device=device),
        "a_log": torch.log(a),
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=device),
        "w_out": layers.dense_init(gen, d_inner, d_model, dtype, device),
    }



def mamba_param_specs():
    """d_inner over the model axis in every leaf that has it."""
    return {
        "w_in": P(None, MODEL_AXIS),
        "conv_w": P(None, MODEL_AXIS),
        "conv_b": P(MODEL_AXIS),
        "w_x": P(MODEL_AXIS, None),
        "w_dt": P(None, MODEL_AXIS),
        "dt_bias": P(MODEL_AXIS),
        "a_log": P(MODEL_AXIS, None),
        "d_skip": P(MODEL_AXIS),
        "w_out": P(MODEL_AXIS, None),
    }

def _causal_conv(x, conv_w, conv_b, state=None):
    """Depthwise causal conv.  x: (B, S, D); conv_w: (K, D); ``state``
    the last K - 1 inputs (B, K - 1, D), zeros when None.  The taps add
    up in the reference's order, each add rounded in x's dtype."""
    k = conv_w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)  # (B, S + K - 1, D)
    s = x.shape[1]
    out = xp[:, 0:s] * conv_w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * conv_w[i]
    return out + conv_b, xp[:, -(k - 1):]


def _ssm_params(params, u, cfg: MambaConfig, dt_rank: int):
    proj = u @ params["w_x"]  # (B, S, dt_rank + 2N)
    dt_low, b_mat, c_mat = proj.split(
        [dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = layers.softplus(
        dt_low @ params["w_dt"] + params["dt_bias"]).float()
    a = -torch.exp(params["a_log"])  # (D, N)
    return dt, a, b_mat.float(), c_mat.float()


def _scan_step(h, a, dt_t, dtu_t, b_t, c_t):
    """One step of the selective scan, out of place: h_t = exp(dt_t * A)
    h + (dt_t * u_t) B_t, y_t = h_t C_t.  h (B, D, N); a (D, N); dt_t and
    dtu_t (B, D); b_t and c_t (B, N).  Returns (h_t, y_t)."""
    da = torch.exp(dt_t[..., None] * a)  # (B, D, N)
    h = da * h + dtu_t[..., None] * b_t[:, None, :]
    return h, torch.einsum("bdn,bn->bd", h, c_t)


def mamba_apply(params, x: torch.Tensor, cfg: MambaConfig) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model)."""
    b, s, d_model = x.shape
    d_inner, dt_rank = mamba_dims(d_model, cfg)
    u, z = (x @ params["w_in"]).chunk(2, dim=-1)  # (B, S, D) each
    u, _ = _causal_conv(u, params["conv_w"], params["conv_b"])
    u = torch.nn.functional.silu(u)
    dt, a, b_mat, c_mat = _ssm_params(params, u, cfg, dt_rank)
    uf = u.float()
    dtu = dt * uf  # (B, S, D): the step's dt_t * u_t
    h = torch.zeros((b, d_inner, cfg.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        h, y_t = _scan_step(h, a, dt[:, t], dtu[:, t], b_mat[:, t],
                            c_mat[:, t])
        ys.append(y_t)
    y = torch.stack(ys, dim=1) + uf * params["d_skip"]
    y = y.to(x.dtype) * torch.nn.functional.silu(z)
    return y @ params["w_out"]


def mamba_init_cache(batch: int, d_model: int, cfg: MambaConfig, dtype,
                     device, *, lead: tuple = ()):
    """The conv window (model dtype) and the ssm state (fp32), behind
    ``lead`` dims (the model's periods)."""
    d_inner, _ = mamba_dims(d_model, cfg)
    return {
        "conv": torch.zeros((*lead, batch, cfg.d_conv - 1, d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((*lead, batch, d_inner, cfg.d_state),
                         dtype=torch.float32, device=device),
    }


def mamba_decode(params, x: torch.Tensor, cache: dict, cfg: MambaConfig):
    """x: (B, 1, d_model); O(1) state update.  The cache is updated in
    place (the reference returns a new one); the same dict is returned."""
    d_inner, dt_rank = mamba_dims(x.shape[-1], cfg)
    u, z = (x @ params["w_in"]).chunk(2, dim=-1)
    u, conv_state = _causal_conv(u, params["conv_w"], params["conv_b"],
                                 state=cache["conv"])
    u = torch.nn.functional.silu(u)
    dt, a, b_mat, c_mat = _ssm_params(params, u, cfg, dt_rank)
    u_t, dt_t = u[:, 0].float(), dt[:, 0]
    b_t, c_t = b_mat[:, 0], c_mat[:, 0]
    h, y = _scan_step(cache["h"], a, dt_t, dt_t * u_t, b_t, c_t)
    y = y + u_t * params["d_skip"]
    y = y[:, None, :].to(x.dtype) * torch.nn.functional.silu(z)
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return y @ params["w_out"], cache


__all__ = ["FP32_LEAVES", "mamba_dims", "mamba_init",
           "mamba_param_specs", "mamba_apply",
           "mamba_init_cache", "mamba_decode"]
