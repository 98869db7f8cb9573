"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``repro.models.xlstm`` (arXiv:2405.04517).  xlstm-1.3b interleaves
mLSTM and sLSTM blocks (7:1); d_ff = 0, each block carries its own up and
down projection (``proj_factor``).  Both recurrences are attention-free
with O(1) decode state and hold no data-dependent collective, so FiCCO
does not apply to them; their projections are plain products.

Both run as loops over time, the reference's ``lax.scan`` step for step.
The mLSTM keeps one (B, H, hd, hd) fp32 matrix memory with stabilised
exponential gating (a per-head running maximum ``m``, -1e30 at the start,
so the first step's forget term is 0); it is never expanded over time.
The sLSTM's input projection ``u @ w_gates`` does not depend on the
state, so it runs once over the whole sequence ahead of the loop; the
recurrent ``h @ r_gates`` runs per step.  Each step returns its new state
out of place and the loops rebind it, so autograd differentiates them
(every step's residuals are kept, as the reference's ``lax.scan`` keeps
them); the decode writes the new state into its cache with one ``copy_``
per leaf.

The casts are the reference's: ``w_if``, ``w_gates`` and ``r_gates`` are
fp32 leaves (:data:`FP32_LEAVES`), and where the reference multiplies a
model-dtype activation by one of them JAX promotes the activation to
fp32, which the port does by hand.  The key scale ``1 / sqrt(hd)`` and
the mLSTM's outer product ``k v^T`` are taken in the model's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import XLSTMConfig
from repro_torch.models import layers
from repro_torch.parallel.sharding import MODEL_AXIS, P

# The leaves the reference keeps in fp32 whatever the model's dtype.
FP32_LEAVES = frozenset({"w_if", "w_gates", "r_gates"})

M_START = -1e30  # the running maxima's start


def _d_inner(d_model: int, cfg: XLSTMConfig) -> int:
    return int(cfg.proj_factor * d_model)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen, d_model: int, num_heads: int, cfg: XLSTMConfig, dtype,
               device):
    d_inner = _d_inner(d_model, cfg)

    def dense(i, o, dt=dtype):
        return layers.dense_init(gen, i, o, dt, device)

    return {
        "w_up": dense(d_model, 2 * d_inner),
        "wq": dense(d_inner, d_inner),
        "wk": dense(d_inner, d_inner),
        "wv": dense(d_inner, d_inner),
        "w_if": dense(d_inner, 2 * num_heads, torch.float32),
        "w_out": dense(d_inner, d_model),
        "skip_scale": torch.ones((d_inner,), dtype=dtype, device=device),
    }



def mlstm_param_specs():
    return {
        "w_up": P(None, MODEL_AXIS),
        "wq": P(None, MODEL_AXIS),
        "wk": P(None, MODEL_AXIS),
        "wv": P(None, MODEL_AXIS),
        "w_if": P(None, None),
        "w_out": P(MODEL_AXIS, None),
        "skip_scale": P(MODEL_AXIS),
    }

def _mlstm_gates(params, u):
    """log i and log sigmoid(f), (B, S, H) each, fp32."""
    log_i, log_f = (u.float() @ params["w_if"]).chunk(2, dim=-1)
    return log_i, -layers.softplus(-log_f)


def _mlstm_qkv(params, u, num_heads: int):
    b, s, d_inner = u.shape
    hd = d_inner // num_heads
    scale = torch.sqrt(torch.tensor(hd, dtype=u.dtype, device=u.device))
    q = (u @ params["wq"]).view(b, s, num_heads, hd)
    k = (u @ params["wk"]).view(b, s, num_heads, hd) / scale
    v = (u @ params["wv"]).view(b, s, num_heads, hd)
    return q, k, v


def _mlstm_step(state: dict, q_t, k_t, v_t, li_t, lf_t):
    """One step of the matrix memory, out of place.  ``state`` holds c
    (B, H, hd, hd), n (B, H, hd) and m (B, H).  Returns (h_t (B, H, hd),
    the new state).  The step's products are taken in the state's dtype
    (fp32 in a model), as the reference casts them."""
    c, m = state["c"], state["m"]
    m_new = torch.maximum(lf_t + m, li_t)
    i_g = torch.exp(li_t - m_new)  # (B, H)
    f_g = torch.exp(lf_t + m - m_new)
    kv = (k_t[..., :, None] * v_t[..., None, :]).to(c.dtype)
    c = f_g[..., None, None] * c + i_g[..., None, None] * kv
    n = f_g[..., None] * state["n"] + i_g[..., None] * k_t.to(c.dtype)
    qf = q_t.to(c.dtype)
    num = torch.einsum("bhd,bhde->bhe", qf, c)
    den = torch.einsum("bhd,bhd->bh", qf, n).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return h, {"c": c, "n": n, "m": m_new}


def mlstm_apply(params, x: torch.Tensor, num_heads: int,
                cfg: XLSTMConfig) -> torch.Tensor:
    b, s, d_model = x.shape
    d_inner = _d_inner(d_model, cfg)
    u, z = (x @ params["w_up"]).chunk(2, dim=-1)
    q, k, v = _mlstm_qkv(params, u, num_heads)
    log_i, log_f = _mlstm_gates(params, u)  # (B, S, H)
    state = mlstm_init_cache(b, d_model, num_heads, cfg, x.device)
    hs = []
    for t in range(s):  # rebinds the state: nothing autograd saved is written
        h_t, state = _mlstm_step(state, q[:, t], k[:, t], v[:, t],
                                 log_i[:, t], log_f[:, t])
        hs.append(h_t)
    h = torch.stack(hs, dim=1).reshape(b, s, d_inner).to(x.dtype)
    h = h + u * params["skip_scale"]
    return (h * F.silu(z)) @ params["w_out"]


def mlstm_init_cache(batch: int, d_model: int, num_heads: int,
                     cfg: XLSTMConfig, device, *, lead: tuple = ()):
    """c (B, H, hd, hd), n (B, H, hd) zeros and m (B, H) at -1e30, all
    fp32, behind ``lead`` dims (the model's periods)."""
    d_inner = _d_inner(d_model, cfg)
    hd = d_inner // num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((*lead, batch, num_heads, hd, hd), **f32),
        "n": torch.zeros((*lead, batch, num_heads, hd), **f32),
        "m": torch.full((*lead, batch, num_heads), M_START, **f32),
    }


def mlstm_decode(params, x: torch.Tensor, cache: dict, num_heads: int,
                 cfg: XLSTMConfig):
    """x: (B, 1, d_model).  The cache is updated in place, one ``copy_``
    per leaf (the reference returns a new one); the same dict is
    returned."""
    b, _, d_model = x.shape
    d_inner = _d_inner(d_model, cfg)
    u, z = (x @ params["w_up"]).chunk(2, dim=-1)
    q, k, v = _mlstm_qkv(params, u, num_heads)
    log_i, log_f = _mlstm_gates(params, u)
    h, new = _mlstm_step(cache, q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                         log_f[:, 0])
    for key, val in new.items():
        cache[key].copy_(val)
    h = h.to(x.dtype).reshape(b, 1, d_inner) + u * params["skip_scale"]
    return (h * F.silu(z)) @ params["w_out"], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen, d_model: int, cfg: XLSTMConfig, dtype, device):
    d_inner = _d_inner(d_model, cfg)
    return {
        "w_up": layers.dense_init(gen, d_model, d_inner, dtype, device),
        "w_gates": layers.dense_init(gen, d_inner, 4 * d_inner,
                                     torch.float32, device),
        "r_gates": torch.randn((d_inner, 4 * d_inner), generator=gen,
                               device=device) * 0.02,
        "w_out": layers.dense_init(gen, d_inner, d_model, dtype, device),
    }



def slstm_param_specs():
    return {
        "w_up": P(None, MODEL_AXIS),
        "w_gates": P(MODEL_AXIS, None),
        "r_gates": P(None, None),
        "w_out": P(MODEL_AXIS, None),
    }

def _slstm_cell(params, g_in, state: dict):
    """One sLSTM step with stabilised exponential gating, out of place.
    ``g_in`` is the step's input term ``u_t @ w_gates`` (B, 4D) fp32;
    ``state`` holds c, n, h and m (B, D) fp32.  Returns (h, the new
    state)."""
    pre = g_in + state["h"] @ params["r_gates"]
    z_p, i_p, f_p, o_p = pre.chunk(4, dim=-1)
    log_f = -layers.softplus(-f_p)
    m = state["m"]
    m_new = torch.maximum(log_f + m, i_p)
    i_g = torch.exp(i_p - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = f_g * state["c"] + i_g * torch.tanh(z_p)
    n = f_g * state["n"] + i_g
    # jnp.maximum's op: a tie passes half the gradient to each side.
    floor = torch.tensor(1e-6, dtype=n.dtype, device=n.device)
    h = torch.sigmoid(o_p) * c / torch.maximum(n, floor)
    return h, {"c": c, "n": n, "h": h, "m": m_new}


def slstm_apply(params, x: torch.Tensor, cfg: XLSTMConfig) -> torch.Tensor:
    b, s, d_model = x.shape
    u = x @ params["w_up"]
    g_in = u.float() @ params["w_gates"]  # (B, S, 4D): no state in it
    state = slstm_init_cache(b, d_model, cfg, x.device)
    hs = []
    for t in range(s):  # rebinds the state: nothing autograd saved is written
        h, state = _slstm_cell(params, g_in[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype) @ params["w_out"]


def slstm_init_cache(batch: int, d_model: int, cfg: XLSTMConfig, device, *,
                     lead: tuple = ()):
    """c, n, h zeros and m at -1e30, (B, D) fp32 each, behind ``lead``
    dims (the model's periods)."""
    shape = (*lead, batch, _d_inner(d_model, cfg))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros(shape, **f32),
        "n": torch.zeros(shape, **f32),
        "h": torch.zeros(shape, **f32),
        "m": torch.full(shape, M_START, **f32),
    }


def slstm_decode(params, x: torch.Tensor, cache: dict, cfg: XLSTMConfig):
    """x: (B, 1, d_model).  The cache is updated in place, one ``copy_``
    per leaf (the reference returns a new one); the same dict is
    returned."""
    u = x @ params["w_up"]
    h, new = _slstm_cell(params, u[:, 0].float() @ params["w_gates"], cache)
    for key, val in new.items():
        cache[key].copy_(val)
    return h[:, None, :].to(x.dtype) @ params["w_out"], cache


__all__ = [
    "FP32_LEAVES", "mlstm_init", "mlstm_param_specs", "mlstm_apply",
    "mlstm_init_cache", "mlstm_decode", "slstm_init", "slstm_param_specs",
    "slstm_apply", "slstm_init_cache", "slstm_decode",
]
