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

On a rank of a group of processes (a ``RankGroup``) the params hold the
rank's blocks by the reference's specs: ``w_up``'s, ``wq``'s, ``wk``'s
and ``wv``'s columns, ``w_gates``'s and ``w_out``'s rows and
``skip_scale``, every one cut on d_inner; ``w_if`` and ``r_gates`` are
whole on every rank (marked ``replicated``).  The mLSTM's ``w_up`` holds
a block of the [u | z] concatenation, so its products are all-gathered
(:func:`~repro_torch.models.layers.rank_halves`); the rank's column
blocks of q, k and v are its H/g heads where g divides H (else the
blocks are gathered to every head), and the forward scan runs on those.
Its decode state ``c`` is cut on the key dim (``c[b, h, d, e]``'s d) and
``n`` on hd where the reference's ``cache_leaf_spec`` cuts them, so a
step takes q and k on the rank's key slice of every head and v whole
(one all-gather of the rank's q, k and v columns) and sums the partial
numerator and denominator in one ``all_reduce``.  The sLSTM's input term
``u @ w_gates`` is a partial sum over the rank's rows, all-reduced; its
recurrence runs alike on every rank, each taking its channels of h for
``w_out``'s rows; at decode, with the state cut on d_inner, the rank
gathers h and computes its channels' four gates.  The group sums the
partial output products (:func:`~repro_torch.models.layers.
rank_output`).  A state the rule keeps whole is updated alike, equal on
every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import XLSTMConfig
from repro_torch.models import layers
from repro_torch.parallel.collectives import all_gather, all_reduce, replicated
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

def _mlstm_gates(params, u, group=None):
    """log i and log sigmoid(f), (B, S, H) each, fp32.  On a rank
    (``group``) the whole ``w_if`` is marked ``replicated``."""
    w_if = params["w_if"]
    if group is not None:
        w_if = replicated(w_if, group=group)
    log_i, log_f = (u.float() @ w_if).chunk(2, dim=-1)
    return log_i, -layers.softplus(-log_f)


def _mlstm_qkv(params, u, num_heads: int, group=None):
    """q, k (scaled) and v (B, S, heads, hd): every head, or on a rank
    (``group``, ``u`` whole) its H/g heads where g divides H, else every
    head, the column blocks gathered
    (:func:`~repro_torch.models.layers._rank_heads`)."""
    b, s, d_inner = u.shape
    hd = d_inner // num_heads
    scale = torch.sqrt(torch.tensor(hd, dtype=u.dtype, device=u.device))

    def heads(key):
        if group is None:
            return (u @ params[key]).view(b, s, num_heads, hd)
        return layers._rank_heads(u, params[key], num_heads, hd, group,
                                  mine=num_heads % group.size == 0)

    return heads("wq"), heads("wk") / scale, heads("wv")


def _mlstm_step(state: dict, q_t, k_t, v_t, li_t, lf_t, group=None):
    """One step of the matrix memory, out of place.  ``state`` holds c
    (B, H, hd, hd), n (B, H, hd) and m (B, H).  Returns (h_t (B, H, hd),
    the new state).  The step's products are taken in the state's dtype
    (fp32 in a model), as the reference casts them.  With ``group`` c
    and n hold a rank's slice of the key dim (c's third dim), q_t and
    k_t the same slice: the numerator and denominator are partial sums
    over it, all-reduced together."""
    c, m = state["c"], state["m"]
    m_new = torch.maximum(lf_t + m, li_t)
    i_g = torch.exp(li_t - m_new)  # (B, H)
    f_g = torch.exp(lf_t + m - m_new)
    kv = (k_t[..., :, None] * v_t[..., None, :]).to(c.dtype)
    c = f_g[..., None, None] * c + i_g[..., None, None] * kv
    n = f_g[..., None] * state["n"] + i_g[..., None] * k_t.to(c.dtype)
    qf = q_t.to(c.dtype)
    num = torch.einsum("bhd,bhde->bhe", qf, c)
    den = torch.einsum("bhd,bhd->bh", qf, n)
    if group is not None:
        both = all_reduce(torch.cat([num, den[..., None]], -1), group=group)
        num, den = both[..., :-1], both[..., -1]
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, {"c": c, "n": n, "m": m_new}


def mlstm_apply(params, x: torch.Tensor, num_heads: int,
                cfg: XLSTMConfig, *, seq: bool = False) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model).  On a ``RankGroup``, with
    ``seq``, the rank's (B, S/g, d) sequence block in and out (the input
    gathered once, :func:`~repro_torch.models.layers.rank_input`); the
    scan runs on the rank's heads (every head where g does not divide
    H), and the rank's channels of its output meet ``w_out``'s rows."""
    d_model = x.shape[-1]
    d_inner = _d_inner(d_model, cfg)
    group = layers.rank_group()
    if group is None:
        u, z = (x @ params["w_up"]).chunk(2, dim=-1)
        first, n = 0, d_inner
    else:
        first, n = layers.rank_channels(d_inner, group)
        x = layers.rank_input(x, group, seq)
        u, z = layers.rank_halves(x, params["w_up"], d_inner, group)
    b, s = x.shape[:2]
    q, k, v = _mlstm_qkv(params, u, num_heads, group)
    log_i, log_f = _mlstm_gates(params, u, group)  # (B, S, H)
    heads = q.shape[2]
    if heads < num_heads:  # the rank's heads
        log_i, log_f = (t.narrow(-1, group.rank * heads, heads)
                        for t in (log_i, log_f))
    state = mlstm_init_cache(b, d_model, num_heads, cfg, x.device)
    state = {key: val.narrow(1, 0, heads) for key, val in state.items()}
    hs = []
    for t in range(s):  # rebinds the state: nothing autograd saved is written
        h_t, state = _mlstm_step(state, q[:, t], k[:, t], v[:, t],
                                 log_i[:, t], log_f[:, t])
        hs.append(h_t)
    h = torch.stack(hs, dim=1).reshape(b, s, -1).to(x.dtype)
    if h.shape[-1] != n:  # every head: the rank's channels
        h = h.narrow(-1, first, n)
    h = h + u.narrow(-1, first, n) * params["skip_scale"]
    out = (h * F.silu(z.narrow(-1, first, n))) @ params["w_out"]
    return out if group is None else layers.rank_output(out, group, seq)


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
    returned.  On a ``RankGroup`` every rank takes every head's q, k and
    v (its column blocks gathered in one all-gather) and updates the
    cache it holds: the rank's slice of the key dim of c and n where the
    reference's rule cuts them (the numerator and denominator summed
    over the ranks), else the whole state, alike on every rank; then its
    channels of h meet ``w_out``'s rows."""
    b, _, d_model = x.shape
    d_inner = _d_inner(d_model, cfg)
    hd = d_inner // num_heads
    group = layers.rank_group()
    if group is None:
        u, z = (x @ params["w_up"]).chunk(2, dim=-1)
        q, k, v = _mlstm_qkv(params, u, num_heads)
        first, n = 0, d_inner
    else:
        first, n = layers.rank_channels(d_inner, group)
        u, z = layers.rank_halves(x, params["w_up"], d_inner, group)
        cols = torch.cat([u @ params[key] for key in ("wq", "wk", "wv")], -1)
        q, k, v = (t.movedim(0, -2).flatten(-2).view(b, 1, num_heads, hd)
                   for t in all_gather(cols, group=group).split(n, -1))
        k = k / torch.sqrt(torch.tensor(hd, dtype=u.dtype, device=u.device))
    log_i, log_f = _mlstm_gates(params, u)
    keys = cache["c"].shape[-2]
    if keys == hd:  # the whole state (on a rank: alike on every rank)
        h, new = _mlstm_step(cache, q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                             log_f[:, 0])
    else:  # the rank's slice of the key dim
        q, k = (t[:, 0].narrow(-1, group.rank * keys, keys) for t in (q, k))
        h, new = _mlstm_step(cache, q, k, v[:, 0], log_i[:, 0], log_f[:, 0],
                             group=group)
    for key, val in new.items():
        cache[key].copy_(val)
    h = h.to(x.dtype).reshape(b, 1, d_inner).narrow(-1, first, n)
    h = h + u.narrow(-1, first, n) * params["skip_scale"]
    out = (h * F.silu(z.narrow(-1, first, n))) @ params["w_out"]
    return (out if group is None else all_reduce(out, group=group)), cache


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
    return _slstm_gates(g_in + state["h"] @ params["r_gates"], state)


def _slstm_gates(pre, state: dict):
    """The step from its gates' pre-activations ``pre`` (B, 4D'), the
    chunks z, i, f, o of the D' channels that ``state`` (B, D') holds."""
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


def _slstm_input(params, u, group=None):
    """The input term ``u @ w_gates`` (fp32, 4D wide) of u (D wide).  On
    a rank (``group``) u holds the rank's channels and the term is the
    group's sum of the rank's partial products with ``w_gates``'s rows,
    marked ``replicated``: the recurrence runs alike on every rank, and
    each rank's cotangent of it is the part through its channels."""
    g_in = u.float() @ params["w_gates"]
    if group is not None:
        g_in = replicated(all_reduce(g_in, group=group), group=group)
    return g_in


def slstm_apply(params, x: torch.Tensor, cfg: XLSTMConfig, *,
                seq: bool = False) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model).  On a ``RankGroup``, with
    ``seq``, the rank's (B, S/g, d) sequence block in and out (the input
    gathered once, :func:`~repro_torch.models.layers.rank_input`); the
    whole recurrence runs on every rank (``r_gates`` whole, marked
    ``replicated``), and the rank's channels of h meet ``w_out``'s
    rows."""
    d_model = x.shape[-1]
    group = layers.rank_group()
    r_gates = params["r_gates"]
    if group is not None:
        x = layers.rank_input(x, group, seq)
        r_gates = replicated(r_gates, group=group)
    b, s = x.shape[:2]
    # (B, S, 4D): no state in it
    g_in = _slstm_input(params, x @ params["w_up"], group)
    state = slstm_init_cache(b, d_model, cfg, x.device)
    hs = []
    for t in range(s):  # rebinds the state: nothing autograd saved is written
        h, state = _slstm_cell({"r_gates": r_gates}, g_in[:, t], state)
        hs.append(h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    if group is None:
        return h @ params["w_out"]
    first, n = layers.rank_channels(h.shape[-1], group)
    return layers.rank_output(h.narrow(-1, first, n) @ params["w_out"],
                              group, seq)


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
    returned.  On a ``RankGroup`` the input term is all-reduced; where
    the cache holds the rank's block of d_inner (the reference's rule
    cuts it), the rank gathers h and computes its channels' gates, the
    columns ``k * D + its channels`` (k = 0..3) of ``r_gates`` and of the
    term; else every rank steps the whole state alike."""
    group = layers.rank_group()
    g_in = _slstm_input(params, (x @ params["w_up"])[:, 0], group)
    if group is None:
        h, new = _slstm_cell(params, g_in, cache)
        out = h
    else:
        d_inner = params["r_gates"].shape[0]
        first, n = layers.rank_channels(d_inner, group)
        if cache["h"].shape[-1] == d_inner:  # whole, alike on every rank
            h, new = _slstm_cell(params, g_in, cache)
            out = h.narrow(-1, first, n)
        else:
            h_all = all_gather(cache["h"], tiled=True, axis=-1, group=group)
            r_gates = params["r_gates"].view(d_inner, 4, d_inner)
            pre = (g_in.view(-1, 4, d_inner).narrow(-1, first, n)
                   + torch.einsum("bd,dkn->bkn", h_all,
                                  r_gates.narrow(-1, first, n)))
            h, new = _slstm_gates(pre.flatten(1), cache)
            out = h
    for key, val in new.items():
        cache[key].copy_(val)
    out = out[:, None, :].to(x.dtype) @ params["w_out"]
    return (out if group is None else all_reduce(out, group=group)), cache


__all__ = [
    "FP32_LEAVES", "mlstm_init", "mlstm_param_specs", "mlstm_apply",
    "mlstm_init_cache", "mlstm_decode", "slstm_init", "slstm_param_specs",
    "slstm_apply", "slstm_init_cache", "slstm_decode",
]
