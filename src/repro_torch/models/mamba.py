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

On a rank of a group of processes (a ``RankGroup``) the params hold the
rank's blocks by the reference's ``mamba_param_specs``: every leaf cut on
d_inner, so the rank runs the scan on its d_inner/g channels alone (the
channels are independent given dt, B and C).  ``w_in``'s column block is
a block of the [u | z] concatenation, not the rank's channels of both
halves, so the ranks all-gather ``x @ w_in``'s column blocks and each
takes its channels of u and z (:func:`~repro_torch.models.layers.
rank_halves`).  ``w_x``'s rows are cut, so ``u @ w_x`` is a partial sum:
one ``all_reduce`` makes dt, B and C whole, and they go alike into every
rank's channels.  The group sums the partial products with ``w_out``'s
row block (:func:`~repro_torch.models.layers.rank_output`).  The decode
state is the rank's block of d_inner where the reference's
``cache_leaf_spec`` cuts it (d_inner of 1024 or more that g divides);
where it keeps it whole, every rank keeps the whole state, equal on
every rank: the conv window from the gathered u, the ssm state gathered
each step.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MambaConfig
from repro_torch.models import layers
from repro_torch.parallel.collectives import all_gather, all_reduce, replicated
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


def _ssm_params(params, u, cfg: MambaConfig, dt_rank: int, group=None):
    """dt (B, S, D) fp32, A (D, N) and B, C (B, S, N) fp32.  On a rank
    (``group``) ``u`` holds its channels and ``w_x`` its rows, so the
    projection is the rank's partial sum: all-reduced, then marked
    ``replicated`` (dt's low rank, B and C go alike into every rank's
    channels, so each rank's cotangent of them is its part)."""
    proj = u @ params["w_x"]  # (B, S, dt_rank + 2N)
    if group is not None:
        proj = replicated(all_reduce(proj, group=group), group=group)
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


def _mixer(params, u, z, cfg: MambaConfig, dt_rank: int, dtype, group=None):
    """The conv, the scan and the gate over u and z (B, S, D) (a rank's
    channels, with ``group``) -> y (B, S, D) before ``w_out``."""
    b, _, d = u.shape
    u, _ = _causal_conv(u, params["conv_w"], params["conv_b"])
    u = torch.nn.functional.silu(u)
    dt, a, b_mat, c_mat = _ssm_params(params, u, cfg, dt_rank, group)
    uf = u.float()
    dtu = dt * uf  # (B, S, D): the step's dt_t * u_t
    h = torch.zeros((b, d, cfg.d_state), dtype=torch.float32,
                    device=u.device)
    ys = []
    for t in range(u.shape[1]):
        h, y_t = _scan_step(h, a, dt[:, t], dtu[:, t], b_mat[:, t],
                            c_mat[:, t])
        ys.append(y_t)
    y = torch.stack(ys, dim=1) + uf * params["d_skip"]
    return y.to(dtype) * torch.nn.functional.silu(z)


def mamba_apply(params, x: torch.Tensor, cfg: MambaConfig, *,
                seq: bool = False) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model).  On a ``RankGroup``, with
    ``seq``, the rank's (B, S/g, d) sequence block in and out: the scan
    needs the whole sequence, so the input is gathered once
    (:func:`~repro_torch.models.layers.rank_input`)."""
    d_inner, dt_rank = mamba_dims(x.shape[-1], cfg)
    group = layers.rank_group()
    if group is None:
        u, z = (x @ params["w_in"]).chunk(2, dim=-1)  # (B, S, D) each
        return _mixer(params, u, z, cfg, dt_rank, x.dtype) @ params["w_out"]
    first, n = layers.rank_channels(d_inner, group)
    u, z = (t.narrow(-1, first, n) for t in layers.rank_halves(
        layers.rank_input(x, group, seq), params["w_in"], d_inner, group))
    y = _mixer(params, u, z, cfg, dt_rank, x.dtype, group)
    return layers.rank_output(y @ params["w_out"], group, seq)


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
    place (the reference returns a new one); the same dict is returned.
    On a ``RankGroup`` the step runs on the rank's channels, and the
    cache holds the rank's block of d_inner or, where the reference's
    rule keeps it whole, every channel, which every rank updates alike:
    the window from the gathered u, the ssm state gathered."""
    d_inner, dt_rank = mamba_dims(x.shape[-1], cfg)
    group = layers.rank_group()
    if group is None:
        u_all, z = (x @ params["w_in"]).chunk(2, dim=-1)
        first, n = 0, d_inner
    else:
        first, n = layers.rank_channels(d_inner, group)
        u_all, z = layers.rank_halves(x, params["w_in"], d_inner, group)
        z = z.narrow(-1, first, n)
    whole = cache["h"].shape[-2] != n  # every channel, on a rank
    conv, h_prev = cache["conv"], cache["h"]
    if whole:
        conv, h_prev = conv.narrow(-1, first, n), h_prev.narrow(-2, first, n)
    u, conv_state = _causal_conv(u_all.narrow(-1, first, n),
                                 params["conv_w"], params["conv_b"],
                                 state=conv)
    u = torch.nn.functional.silu(u)
    dt, a, b_mat, c_mat = _ssm_params(params, u, cfg, dt_rank, group)
    u_t, dt_t = u[:, 0].float(), dt[:, 0]
    b_t, c_t = b_mat[:, 0], c_mat[:, 0]
    h, y = _scan_step(h_prev, a, dt_t, dt_t * u_t, b_t, c_t)
    y = y + u_t * params["d_skip"]
    y = y[:, None, :].to(x.dtype) * torch.nn.functional.silu(z)
    if whole:
        conv_state = torch.cat([cache["conv"], u_all], 1)[:, 1:]
        h = all_gather(h, tiled=True, axis=1, group=group)
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    out = y @ params["w_out"]
    return (out if group is None else all_reduce(out, group=group)), cache


__all__ = ["FP32_LEAVES", "mamba_dims", "mamba_init",
           "mamba_param_specs", "mamba_apply",
           "mamba_init_cache", "mamba_decode"]
