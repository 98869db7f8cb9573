"""Card-resident mixed-precision sweeps, the ``"mixed"`` engine (port of
``repro.sweep.device``).

Three pieces that together keep a 1e8-lane sweep on the card:

  * **On-card synthesis** — a counter-based splitmix64 generator whose
    numpy twin (:func:`host_batch`, :func:`host_ragged_batch`) runs the
    same arithmetic, so a shard materialises from ``(seed, lane_range)``
    directly in device memory: integer fields equal the twin's at every
    lane, fractions agree to libm ulps.  Every draw is a pure function of
    ``(seed, field, lane)``, so lane ``i`` draws the same scenario however
    the sweep is sharded.  torch has no uint64 arithmetic, so the card
    runs splitmix64 in int64: products and sums wrap in two's complement
    as uint64's do modulo 2**64, the constants above 2**63 enter as their
    int64 images, and each logical right shift is an arithmetic one
    masked to its low ``64 - s`` bits.
  * **Mixed-precision evaluation** — :func:`evaluate_mixed_grid` /
    :func:`dispatch_mixed_grid` pack the machine leaves at
    bf16/f32/f64 (``torchgrid.machine_arrays(dtype=...)``) and run the
    ``"torch"`` engine's tensor math unchanged; the pipeline still
    accumulates in float64.  The two-phase ``dispatch`` queues the work
    and the copies back and returns a ``finalize()`` thunk without
    synchronising, so the double-buffered shard loop keeps shard ``k+1``
    running on the card while shard ``k`` materialises on the host.
  * **Fused statistics** — :func:`sweep_device_stats` runs synthesis,
    grid evaluation *and* the :class:`~repro_torch.learn.stats.GateStats`
    integer-histogram reduction on the card shard by shard, so only the
    histogram and a few summary numbers ever leave it; no ``(L, S, M)``
    ``GridResult`` is assembled.  The heuristic twins (gate terms, base
    picks, features) run in float64 whatever the evaluation dtype,
    mirroring ``GateStats.update_from_grid`` operation for operation.

Dirichlet note: ragged profiles use Marsaglia–Tsang gamma sampling
(boosted for concentration < 1) with four fixed, vectorised
accept-rounds; the ~1e-5 of lanes still unresolved after four rounds
fall back deterministically to the distribution mode.  The profiles are
distribution-equivalent to ``synth.synthetic_ragged_batch`` but not
stream-identical to it; parity is defined against the numpy twin.

Every entry point that touches the card takes ``device``: ``None`` means
the card, and a host without CUDA raises unless the caller passes
``device="cpu"``.  There is no compiler: the reference's one jitted
program per shard is a sequence of eager launches here.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.core.batch import RaggedBatch, ScenarioBatch
from repro_torch.core.engine import (
    GRID_SCHEDULES,
    SCHEDULE_INDEX,
    GridResult,
    as_scenario_sequence,
    is_ragged,
)
from repro_torch.core.heuristics import (
    _GATE_COMM_CIL,
    MIN_DECOMPOSE_FLOPS,
    machine_threshold,
)
from repro_torch.core.schedule_types import Schedule
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.sweep.plan import plan_shards, shards_for_host
from repro_torch.sweep.runner import ShardSummary, SweepResult
from repro_torch.sweep.synth import _M_QUANTUM

# ---------------------------------------------------------------------------
# Counter-based generator (splitmix64): uint64 on numpy, int64 on torch.
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1
_MIX1, _MIX2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
_GOLD = 0x9E3779B97F4A7C15
_U_MIX1, _U_MIX2, _U_GOLD = (np.uint64(c) for c in (_MIX1, _MIX2, _GOLD))

# Field addresses (the per-(seed, field) key spaces never collide).
_FIELD_M, _FIELD_N, _FIELD_K, _FIELD_B, _FIELD_SHORT, _FIELD_TAIL = range(6)
_FIELD_GAMMA0 = 16  # gamma draws for ragged step s start at 16 + 16*s
_GAMMA_STRIDE = 16
_GAMMA_ROUNDS = 4  # fixed vectorised accept-rounds (3 draws each)
_GAMMA_BOOST = 12  # 13th draw of a step: the alpha<1 boost uniform

_F = torch.float64
_I = torch.int64


def _i64(x: int) -> int:
    """The int64 image of a uint64 value (same bits)."""
    x &= _MASK64
    return x - (1 << 64) if x >> 63 else x


_I_MIX1, _I_MIX2, _I_GOLD = (_i64(c) for c in (_MIX1, _MIX2, _GOLD))


def _mix64_int(x: int) -> int:
    """Scalar splitmix64 finalizer on python ints (key derivation)."""
    z = x & _MASK64
    z = ((z ^ (z >> 30)) * _MIX1) & _MASK64
    z = ((z ^ (z >> 27)) * _MIX2) & _MASK64
    return z ^ (z >> 31)


def _field_key(seed: int, field: int) -> int:
    """Per-(seed, field) stream key, a plain python int."""
    return _mix64_int((_mix64_int(seed & _MASK64) + field * _GOLD) & _MASK64)


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix64(z):
    """Vector splitmix64 finalizer: numpy uint64 or torch int64 bits."""
    if isinstance(z, np.ndarray):
        z = (z ^ (z >> np.uint64(30))) * _U_MIX1
        z = (z ^ (z >> np.uint64(27))) * _U_MIX2
        return z ^ (z >> np.uint64(31))
    z = (z ^ _srl(z, 30)) * _I_MIX1
    z = (z ^ _srl(z, 27)) * _I_MIX2
    return z ^ _srl(z, 31)


def _u01(key: int, lane):
    """Uniform draw in (0, 1] (log-safe), exact function of (key, lane).

    The top 53 bits map to ``(k + 1) * 2**-53``: every step (integer
    ops, a conversion of a value <= 2**53, power-of-two scaling) is
    exact, so numpy and torch produce bit-identical uniforms.
    """
    if isinstance(lane, np.ndarray):
        bits = _mix64(np.uint64(key) + lane * _U_GOLD)
        return ((bits >> np.uint64(11)) + np.uint64(1)).astype(
            np.float64
        ) * (2.0 ** -53)
    bits = _mix64(lane * _I_GOLD + _i64(key))
    return (_srl(bits, 11) + 1).to(_F) * (2.0 ** -53)


# ---------------------------------------------------------------------------
# The numpy host twins (the reference's arithmetic, verbatim).
# ---------------------------------------------------------------------------


def _np_int_field(key: int, lane, quantum: int, lo: float, hi: float):
    """``quantum * int(exp(U(log lo, log hi)))`` — the synth.py recipe
    (truncate-then-multiply, matching ``synthetic_batch``)."""
    u = _u01(key, lane)
    v = np.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
    return quantum * v.astype(np.int64)


def _np_choice_field(key: int, lane, choices):
    u = _u01(key, lane)
    i = np.minimum(np.floor(u * len(choices)).astype(np.int64),
                   len(choices) - 1)
    return np.asarray(choices, dtype=np.int64)[i]


def _np_synth_uniform(lane, seed: int, dtype_bytes):
    """(m, n, k, b) int64 arrays; same ranges as ``synthetic_batch``."""
    m = _np_int_field(_field_key(seed, _FIELD_M), lane, _M_QUANTUM, 1, 2048)
    n = _np_int_field(_field_key(seed, _FIELD_N), lane, 128, 8, 512)
    k = _np_int_field(_field_key(seed, _FIELD_K), lane, 128, 8, 512)
    b = _np_choice_field(_field_key(seed, _FIELD_B), lane, tuple(dtype_bytes))
    return m, n, k, b


def _np_gamma_boosted(seed: int, lane, step: int, alpha: float):
    """Gamma(alpha) draws via Marsaglia–Tsang at ``alpha + 1`` plus the
    ``u**(1/alpha)`` boost; four fixed accept-rounds, stragglers fall
    back to ``d`` (the distribution mode)."""
    d = (alpha + 1.0) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    base = _FIELD_GAMMA0 + step * _GAMMA_STRIDE
    g = np.full(lane.shape, -1.0, dtype=np.float64)
    for j in range(_GAMMA_ROUNDS):
        u1 = _u01(_field_key(seed, base + 3 * j), lane)
        u2 = _u01(_field_key(seed, base + 3 * j + 1), lane)
        ua = _u01(_field_key(seed, base + 3 * j + 2), lane)
        # Box–Muller normal from two (0, 1] uniforms.
        x = np.sqrt(-2.0 * np.log(u1)) * np.cos((2.0 * math.pi) * u2)
        v = (1.0 + c * x) ** 3
        v_safe = np.where(v > 0.0, v, 1.0)
        ok = (v > 0.0) & (
            np.log(ua) < 0.5 * x * x + d - d * v_safe + d * np.log(v_safe)
        )
        g = np.where((g < 0.0) & ok, d * v_safe, g)
    g = np.where(g < 0.0, d, g)
    boost = _u01(_field_key(seed, base + _GAMMA_BOOST), lane)
    return g * boost ** (1.0 / alpha)


def _np_synth_frac(lane, seed: int, steps: int, concentration: float):
    """(S, steps) float64 Dirichlet profiles with masked short tails:
    ~25% of rows truncated to a random tail in [1, steps-1], then rows
    renormalised to sum to 1."""
    gs = np.stack(
        [_np_gamma_boosted(seed, lane, s, concentration)
         for s in range(steps)],
        axis=1,
    )
    if steps > 1:
        short = _u01(_field_key(seed, _FIELD_SHORT), lane) < 0.25
        u_tail = _u01(_field_key(seed, _FIELD_TAIL), lane)
        tail = np.minimum(
            (1.0 + np.floor(u_tail * (steps - 1))).astype(np.int64),
            steps - 1,
        )
        cols = np.arange(steps, dtype=np.int64)[None, :]
        gs = np.where(short[:, None] & (cols >= tail[:, None]), 0.0, gs)
    return gs / gs.sum(axis=1, keepdims=True)


def _np_lanes(n: int, start: int):
    return np.uint64(int(start)) + np.arange(n, dtype=np.uint64)


def host_batch(
    n: int, *, seed: int = 0, start: int = 0, dtype_bytes=(2, 1)
) -> ScenarioBatch:
    """Numpy twin of :func:`device_batch` — bit-identical integers.

    ``start`` is the global lane offset: ``host_batch(k, start=s)`` is
    rows ``[s, s+k)`` of ``host_batch(s+k)``, which is what lets every
    shard regenerate exactly its slice.
    """
    m, nn, kk, b = _np_synth_uniform(_np_lanes(n, start), seed, dtype_bytes)
    return ScenarioBatch(m=m, n=nn, k=kk, dtype_bytes=b)


def host_ragged_batch(
    n: int,
    *,
    seed: int = 0,
    start: int = 0,
    steps: int = 8,
    concentration: float = 0.7,
    dtype_bytes=(2, 1),
) -> RaggedBatch:
    """Numpy twin of :func:`device_ragged_batch`."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    lane = _np_lanes(n, start)
    m, nn, kk, b = _np_synth_uniform(lane, seed, dtype_bytes)
    frac = _np_synth_frac(lane, seed, steps, concentration)
    return RaggedBatch(m=m, n=nn, k=kk, dtype_bytes=b, frac=frac)


# ---------------------------------------------------------------------------
# The torch twins (int64 bits, float64 draws; no host value enters, so
# nothing here synchronises the card).
# ---------------------------------------------------------------------------


def _int_field(key: int, lane, quantum: int, lo: float, hi: float):
    u = _u01(key, lane)
    v = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
    return quantum * v.to(_I)


def _choice_field(key: int, lane, choices):
    u = _u01(key, lane)
    i = torch.clamp_max(torch.floor(u * len(choices)).to(_I),
                        len(choices) - 1)
    # A select chain over the few choices: a tensor of them built from
    # host values would synchronise the card.
    out = torch.full_like(i, int(choices[0]))
    for j, c in enumerate(choices[1:], start=1):
        out = torch.where(i == j, int(c), out)
    return out


def _synth_uniform(lane, seed: int, dtype_bytes):
    m = _int_field(_field_key(seed, _FIELD_M), lane, _M_QUANTUM, 1, 2048)
    n = _int_field(_field_key(seed, _FIELD_N), lane, 128, 8, 512)
    k = _int_field(_field_key(seed, _FIELD_K), lane, 128, 8, 512)
    b = _choice_field(_field_key(seed, _FIELD_B), lane, tuple(dtype_bytes))
    return m, n, k, b


def _gamma_boosted(seed: int, lane, step: int, alpha: float):
    """:func:`_np_gamma_boosted` in torch, operation for operation."""
    d = (alpha + 1.0) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    base = _FIELD_GAMMA0 + step * _GAMMA_STRIDE
    g = torch.full(lane.shape, -1.0, dtype=_F, device=lane.device)
    for j in range(_GAMMA_ROUNDS):
        u1 = _u01(_field_key(seed, base + 3 * j), lane)
        u2 = _u01(_field_key(seed, base + 3 * j + 1), lane)
        ua = _u01(_field_key(seed, base + 3 * j + 2), lane)
        x = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
        # numpy's ``** 3`` is a libm pow; torch's pow by the scalar 3
        # is x*x*x, so the exponent goes in as a tensor.
        base3 = 1.0 + c * x
        v = torch.pow(base3, torch.full_like(base3, 3.0))
        v_safe = torch.where(v > 0.0, v, 1.0)
        ok = (v > 0.0) & (
            torch.log(ua)
            < 0.5 * x * x + d - d * v_safe + d * torch.log(v_safe)
        )
        g = torch.where((g < 0.0) & ok, d * v_safe, g)
    g = torch.where(g < 0.0, d, g)
    boost = _u01(_field_key(seed, base + _GAMMA_BOOST), lane)
    return g * torch.pow(boost, 1.0 / alpha)


def _row_sum(cols):
    """numpy's ``a.sum(axis=1)`` over ``(S, n)``, column tensors in the
    order numpy adds them (its pairwise sum: a plain loop below 8
    columns, eight running sums combined as a tree up to 128)."""
    n = len(cols)
    if n < 8:
        res = cols[0]
        for c in cols[1:]:
            res = res + c
        return res
    if n > 128:
        return torch.stack(cols, dim=1).sum(dim=1)
    r = list(cols[:8])
    i = 8
    while i < n - n % 8:
        r = [r[j] + cols[i + j] for j in range(8)]
        i += 8
    res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for c in cols[i:]:
        res = res + c
    return res


def _synth_frac(lane, seed: int, steps: int, concentration: float):
    cols = [_gamma_boosted(seed, lane, s, concentration)
            for s in range(steps)]
    if steps > 1:
        short = _u01(_field_key(seed, _FIELD_SHORT), lane) < 0.25
        u_tail = _u01(_field_key(seed, _FIELD_TAIL), lane)
        tail = torch.clamp_max(
            (1.0 + torch.floor(u_tail * (steps - 1))).to(_I), steps - 1
        )
        cols = [torch.where(short & (tail <= s), 0.0, c)
                for s, c in enumerate(cols)]
    total = _row_sum(cols)
    return torch.stack([c / total for c in cols], dim=1)


def _lanes(n: int, start: int, device):
    return torch.arange(int(start), int(start) + n, dtype=_I, device=device)


def device_batch(
    n: int, *, seed: int = 0, start: int = 0, dtype_bytes=(2, 1),
    device=None,
) -> ScenarioBatch:
    """On-card synthesis, materialised back as a ScenarioBatch.

    The materialised form exists for parity tests and engine reuse; the
    fused sweep (:func:`sweep_device_stats`) never leaves the card.
    """
    lane = _lanes(n, start, resolve_device(device))
    m, nn, kk, b = _synth_uniform(lane, seed, dtype_bytes)
    return ScenarioBatch(m=m.cpu().numpy(), n=nn.cpu().numpy(),
                         k=kk.cpu().numpy(), dtype_bytes=b.cpu().numpy())


def device_ragged_batch(
    n: int,
    *,
    seed: int = 0,
    start: int = 0,
    steps: int = 8,
    concentration: float = 0.7,
    dtype_bytes=(2, 1),
    device=None,
) -> RaggedBatch:
    """On-card ragged synthesis, materialised as a RaggedBatch."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    lane = _lanes(n, start, resolve_device(device))
    m, nn, kk, b = _synth_uniform(lane, seed, dtype_bytes)
    frac = _synth_frac(lane, seed, steps, concentration)
    return RaggedBatch(m=m.cpu().numpy(), n=nn.cpu().numpy(),
                       k=kk.cpu().numpy(), dtype_bytes=b.cpu().numpy(),
                       frac=frac.cpu().numpy())


# ---------------------------------------------------------------------------
# Mixed-precision grid evaluation (the "mixed" engine's backend).
# ---------------------------------------------------------------------------

_DTYPES = {"float64": None, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def _check_dtype(dtype: str) -> torch.dtype | None:
    if dtype not in _DTYPES:
        raise ValueError(
            f"dtype must be one of {tuple(_DTYPES)}, got {dtype!r}"
        )
    return _DTYPES[dtype]


def _coerce(scenarios):
    from repro_torch.core import batch as _batch

    scenarios = as_scenario_sequence(scenarios)
    if is_ragged(scenarios):
        return _batch._as_ragged_batch(scenarios)
    return _batch._as_batch(scenarios)


def dispatch_mixed_grid(
    scenarios,
    machines,
    *,
    dtype: str = "float32",
    dma: bool = True,
    dma_into_place: bool = False,
    schedules=GRID_SCHEDULES,
    device=None,
):
    """Queue a mixed-precision grid evaluation; returns ``finalize()``.

    The operands reach the card, the grid is computed and its copy back
    is queued without a synchronisation (``torchgrid.to_device``,
    ``to_host_async``), so the card starts computing while this returns
    and keeps computing whatever is queued after it.  ``finalize()``
    waits for this grid's copies only and assembles the
    :class:`GridResult`.
    """
    from repro_torch.autotune import torchgrid

    leaf_dtype = _check_dtype(dtype)
    dev = resolve_device(device)
    machines = tuple(machines)
    schedules = tuple(schedules)
    sb = _coerce(scenarios)
    with _trace.span(
        "sweepdevice/dispatch", "sweepdevice",
        dtype=dtype, n_scenarios=len(sb), n_machines=len(machines),
    ):
        mp = torchgrid.machine_arrays(machines, dtype=leaf_dtype, device=dev)
        g_max = max(m.group for m in machines)
        evaluate = (torchgrid.evaluate_ragged_grid_raw
                    if isinstance(sb, RaggedBatch)
                    else torchgrid.evaluate_grid_raw)
        out = evaluate(sb, mp, dma=dma, dma_into_place=dma_into_place,
                       schedules=schedules, g_max=g_max)
        wait = torchgrid.to_host_async(out)

    def finalize() -> GridResult:
        # The wait for the copies back is the "compute" half of the
        # two-phase overlap.
        with _trace.span(
            "sweepdevice/finalize", "sweepdevice",
            dtype=dtype, n_scenarios=len(sb),
        ):
            return GridResult.from_machine_major(
                wait(), schedules=schedules, scenarios=sb, machines=machines,
                dma=dma,
            )

    return finalize


def evaluate_mixed_grid(
    scenarios,
    machines,
    *,
    dtype: str = "float32",
    dma: bool = True,
    dma_into_place: bool = False,
    schedules=GRID_SCHEDULES,
    device=None,
) -> GridResult:
    """Synchronous form of :func:`dispatch_mixed_grid`."""
    return dispatch_mixed_grid(
        scenarios, machines, dtype=dtype, dma=dma,
        dma_into_place=dma_into_place, schedules=schedules, device=device,
    )()


# ---------------------------------------------------------------------------
# Fused synthesis + evaluation + GateStats reduction.
# ---------------------------------------------------------------------------

# The five base-pick rows: a select chain over contiguous rows avoids a
# strided gather along the schedule axis.
_PICKS = tuple(sorted({
    SCHEDULE_INDEX[s] for s in (
        Schedule.SERIAL, Schedule.UNIFORM_FUSED_2D,
        Schedule.UNIFORM_FUSED_1D, Schedule.HETERO_UNFUSED_1D,
        Schedule.HETERO_FUSED_1D,
    )
}))


def _quantize_regret(t, tb):
    """Torch twin of ``repro_torch.learn.stats._quantize_regret``
    (``torch.round`` is round-half-even, as ``np.rint``)."""
    from repro_torch.learn.stats import REGRET_CAP, REGRET_SCALE

    regret = t / tb - 1.0
    regret = torch.nan_to_num(
        regret, nan=REGRET_CAP, posinf=REGRET_CAP, neginf=0.0
    )
    regret = torch.clamp(regret, 0.0, REGRET_CAP)
    return torch.round(regret * REGRET_SCALE).to(_I)


def _stats_machines(m, n, k, b, imb, act, mp, thr, edges, t, tb):
    """Every machine's GateStats contribution, all float64, on the card.

    Twins ``GateStats.update_from_grid``'s per-machine body operation
    for operation (terms -> score -> base picks -> features -> bins),
    batched over the machine axis: ``mp`` holds float64 ``(M, 1)``
    machine columns, ``thr`` the ``(M, 1)`` thresholds, ``t`` the
    nan_to_num'd ``(M, L, S)`` totals and ``tb`` the ``(M, S)`` best
    totals; ``act`` is None for uniform batches (the ``group``
    sentinel).  Returns the ``(M, S)`` flat histogram cell, the
    ``(M, S, 5)`` stat payload and the ``(M, F, 3)`` feature moments.
    """
    from repro_torch.autotune import torchgrid
    from repro_torch.learn.features import GATE_FEATURES
    from repro_torch.learn.stats import FEATURE_EDGES

    mf, nf, kf, bf = (a.to(_F) for a in (m, n, k, b))
    g = mp.group
    gf = g.to(_F)
    shape = (g.shape[0], m.shape[0])

    # -- serial_gate_terms_batch twin (floats first, like the source) --
    dev_n = torch.where(torch.remainder(nf, gf) == 0.0, nf / gf, nf)
    mk_bytes = mf * kf * bf
    ag_bw = torch.where(mp.is_mesh, mp.link_bw * (g - 1).to(_F),
                        mp.link_bw * mp.a2a_links.to(_F))
    t_comm = mk_bytes / ag_bw
    t_gemm = 2.0 * mf * dev_n * kf / mp.peak_flops
    r = t_comm / t_gemm
    t_serial_ag = torchgrid.ag_serial_time(mk_bytes, mp)
    t_chunked_ag = gf * torchgrid.a2a_chunk_step_time(
        mk_bytes / (gf * gf), mp
    )
    inflate = t_chunked_ag / t_serial_ag
    score = r * (inflate * _GATE_COMM_CIL - 1.0)

    # -- select_schedule_batch twin (serial_gate=inf -> flops guard) ---
    flops_i = 2.0 * mf * n * k  # the numpy source's int chain
    bytes_i = (m * k + k * n + m * n).to(_F) * b
    metric = (flops_i / bytes_i) * bytes_i
    base = torch.full(shape, SCHEDULE_INDEX[Schedule.HETERO_FUSED_1D],
                      dtype=_I, device=m.device)
    for cond, pick in (
        (metric >= 5.0 * thr, Schedule.HETERO_UNFUSED_1D),
        (metric < thr, Schedule.UNIFORM_FUSED_1D),
        (m < k, Schedule.UNIFORM_FUSED_2D),
        (flops_i < MIN_DECOMPOSE_FLOPS, Schedule.SERIAL),
    ):  # np.select's first true condition wins: apply them last to first
        base = torch.where(cond, SCHEDULE_INDEX[pick], base)

    # -- feature_matrix twin (floats-first sums, unlike the picks) -----
    act_col = torch.broadcast_to(gf, shape) if act is None else act
    flops_f = 2.0 * mf * nf * kf
    bytes_f = (mf * kf + kf * nf + mf * nf) * bf
    otb = flops_f / bytes_f
    m_over_k = mf / kf
    log_flops = torch.log10(torch.clamp_min(flops_f, 1.0))
    cil = torchgrid.comm_cil(mf / gf, dev_n, kf, bf, mp, degree=4)
    feats = torch.stack(
        [torch.broadcast_to(f, shape) for f in (
            imb, act_col, otb, r, inflate, cil, log_flops, m_over_k, gf,
            mp.peak_flops / mp.hbm_bw,
        )],
        dim=2,
    )

    # -- binning (GATE_FEATURES order, then score) ---------------------
    cols = {"imbalance": imb, "active_steps": act_col, "otb": otb, "r": r}
    idx = torch.zeros(shape, dtype=_I, device=m.device)
    for fname in GATE_FEATURES:
        col = torch.broadcast_to(cols[fname], shape).contiguous()
        idx = idx * (len(FEATURE_EDGES[fname]) + 1) + torch.searchsorted(
            edges[fname], col, right=True
        )
    idx = idx * (len(edges["score"]) + 1) + torch.searchsorted(
        edges["score"], score.contiguous(), right=True
    )

    t_serial = t[:, SCHEDULE_INDEX[Schedule.SERIAL], :]
    t_pick = torch.full_like(tb, math.inf)
    for j in _PICKS:
        t_pick = torch.where(base == j, t[:, j, :], t_pick)
    payload = torch.stack(
        [
            torch.ones(shape, dtype=_I, device=m.device),
            (t_serial <= 1.05 * tb).to(_I),
            (t_pick <= 1.05 * tb).to(_I),
            _quantize_regret(t_serial, tb),
            _quantize_regret(t_pick, tb),
        ],
        dim=2,
    )

    finite = torch.isfinite(feats)
    mom = torch.stack(
        [
            finite.sum(dim=1).to(_F),
            torch.where(finite, feats, 0.0).sum(dim=1),
            torch.where(finite, feats ** 2, 0.0).sum(dim=1),
        ],
        dim=2,
    )
    return idx, payload, mom


def _shard(start, stop, ctx):
    """One shard's fused program: synthesis, the grid, the schedule
    minimum, the summary tallies and (``ctx["collect"]``) the histogram
    scatter into the running accumulator.  Everything is queued; nothing
    synchronises.  Returns the small per-shard tensors for the host."""
    from repro_torch.autotune import torchgrid

    mp_dt = ctx["mp_dt"]
    dev = mp_dt.group.device
    M, L = mp_dt.group.shape[0], len(GRID_SCHEDULES)
    lane = _lanes(stop - start, start, dev)
    m, nn, kk, b = _synth_uniform(lane, ctx["seed"], ctx["dtype_bytes"])
    if ctx["steps"] is None:
        # closed_form=True: the exact closed-form pipeline for uniform
        # schedules (equal to the loop up to rounding), about half the
        # elementwise passes: the sweep's fast path.
        frac64 = None
        outs = torchgrid._eval_machines(
            m, nn, kk, b, mp_dt, ctx["g_max"], GRID_SCHEDULES, ctx["dma"],
            ctx["dma_into_place"], closed_form=True,
        )
    else:
        frac64 = _synth_frac(lane, ctx["seed"], ctx["steps"],
                             ctx["concentration"])
        outs = torchgrid._eval_machines_ragged(
            m, nn, kk, b, frac64.to(mp_dt.peak_flops.dtype), mp_dt,
            ctx["g_max"], GRID_SCHEDULES, ctx["dma"], ctx["dma_into_place"],
        )
    # The busy and exposed rows are not needed here: free them now.
    total, valid, sc, sg = outs[0], outs[5], outs[6], outs[7]
    del outs
    tv = torch.where(valid, total, math.inf)
    # Min/argmin over the schedule axis as L contiguous (M, S) passes;
    # ``<`` keeps the first minimum, as np.argmin does.
    tb = tv[:, 0, :]
    best = torch.zeros(tb.shape, dtype=_I, device=dev)
    for j in range(1, L):
        better = tv[:, j, :] < tb
        tb = torch.where(better, tv[:, j, :], tb)
        best = torch.where(better, j, best)
    del tv
    # A bincount over best + L * machine, by index_add_: torch.bincount
    # reads the largest index back to the host first (a synchronisation).
    flat = best + ctx["machine_rows"]
    best_counts = torch.zeros(M * L, dtype=_I, device=dev).index_add_(
        0, flat.reshape(-1), torch.ones_like(flat).reshape(-1)
    ).reshape(M, L)
    n_prof = (best != SCHEDULE_INDEX[Schedule.SERIAL]).sum()
    speedup = (sc + sg) / tb
    fin = torch.isfinite(speedup)
    small = [best_counts, n_prof, torch.where(fin, speedup, 0.0).sum(),
             fin.sum()]
    if ctx["collect"]:
        if frac64 is None:
            imb = torch.ones(lane.shape, dtype=_F, device=dev)
            act = None
        else:
            act = (frac64 > 0.0).sum(dim=1).to(_F)
            imb = frac64.max(dim=1).values * act
        t = torch.nan_to_num(total, nan=math.inf, posinf=math.inf)
        del total
        idx, payload, mom = _stats_machines(
            m, nn, kk, b, imb, act, ctx["cols64"], ctx["thr"], ctx["edges"],
            t, tb,
        )
        cell = (idx + ctx["bucket_base"]) * payload.shape[2]
        cell = cell[:, :, None] + torch.arange(payload.shape[2], device=dev)
        ctx["hist"].index_add_(0, cell.reshape(-1), payload.reshape(-1))
        small.append(mom)
    return small


def sweep_device_stats(
    n_scenarios: int,
    machines,
    *,
    seed: int = 0,
    dtype: str = "float32",
    num_shards: int | None = None,
    ragged: bool = False,
    steps: int = 8,
    concentration: float = 0.7,
    dtype_bytes=(2, 1),
    dma: bool = True,
    dma_into_place: bool = False,
    host_index: int = 0,
    host_count: int = 1,
    on_shard=None,
    overlap_dispatch: bool = True,
    collect_stats: bool = True,
    per_family: bool = False,
    device=None,
):
    """The card-resident sweep: synthesis + grid + statistics per shard.

    Shards the global lane range ``[0, n_scenarios)`` with the standard
    deterministic plan (so multi-host runs regenerate exactly their
    owned lanes) and queues each owned shard's fused program.  The
    histogram accumulates on the card across shards (int64 scatter-adds:
    exact, so any order gives the same counts); each shard's summary
    tallies are copied back asynchronously.  With ``overlap_dispatch``
    (default on; this path has no bit-identity contract to preserve)
    shard ``k+1`` is queued before shard ``k``'s tallies are waited for,
    so the card computes ``k+1`` while the host reduces ``k``.
    Per-shard ``seconds`` therefore overlap wall-clock; their sum exceeds
    elapsed time by design.

    Returns ``(stats, sweep_result)``:

      * ``stats`` — a :class:`~repro_torch.learn.stats.GateStats` (or,
        with ``per_family=True``, a dict mapping machine-family name —
        the ``name.split("/")[0]`` prefix — to its own GateStats;
        families sum to the global statistics exactly).  ``None`` when
        ``collect_stats=False``.
      * ``sweep_result`` — a reduce-mode :class:`SweepResult` whose
        summaries mirror ``sweep_grid``'s (``on_shard`` streams them).

    The histogram is binned from float64 heuristic twins, so a gate
    trained from it matches host-reduced training up to bin-edge ulps
    whatever the evaluation ``dtype``.
    """
    from repro_torch.autotune import torchgrid
    from repro_torch.learn.features import FEATURE_NAMES, GATE_FEATURES
    from repro_torch.learn.stats import (
        FEATURE_EDGES,
        SCORE_EDGES,
        GateStats,
        _hist_shape,
    )

    leaf_dtype = _check_dtype(dtype)
    if ragged and steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = resolve_device(device)
    machines = tuple(machines)
    M, L = len(machines), len(GRID_SCHEDULES)
    families = [m.name.split("/", 1)[0] for m in machines]
    buckets = list(dict.fromkeys(families)) if per_family else ["__all__"]
    fam_of = [buckets.index(f) if per_family else 0 for f in families]
    shape = _hist_shape()
    cells = int(np.prod(shape))

    plan = plan_shards(
        n_scenarios, num_shards if num_shards is not None else host_count
    )
    owned = shards_for_host(plan, host_index, host_count)

    def on_card(values, dt):
        return torchgrid.to_device(torch.tensor(values, dtype=dt), dev)

    ctx = {
        "seed": seed, "steps": steps if ragged else None,
        "concentration": concentration, "dtype_bytes": tuple(dtype_bytes),
        "dma": dma, "dma_into_place": dma_into_place,
        "collect": collect_stats,
        "g_max": max(m.group for m in machines),
        "mp_dt": torchgrid.machine_arrays(machines, dtype=leaf_dtype,
                                          device=dev),
        "cols64": torchgrid._columns(
            torchgrid.machine_arrays(machines, device=dev)),
        "machine_rows": on_card([[j * L] for j in range(M)], _I),
        "thr": on_card([[machine_threshold(m)] for m in machines], _F),
        "bucket_base": on_card([[f * (cells // shape[-1])] for f in fam_of],
                               _I),
        "edges": {
            **{f: on_card(list(FEATURE_EDGES[f]), _F)
               for f in GATE_FEATURES},
            "score": on_card(list(SCORE_EDGES), _F),
        },
        "hist": (torch.zeros(len(buckets) * cells, dtype=_I, device=dev)
                 if collect_stats else None),
    }

    summaries: list[ShardSummary] = []
    mom_acc = np.zeros((len(buckets), len(FEATURE_NAMES), 3))
    pts_acc = np.zeros(len(buckets), dtype=np.int64)
    bc_acc = np.zeros((len(buckets), L), dtype=np.int64)
    reg = _metrics.get_metrics()

    def _dispatch(shard):
        start, stop = plan.bounds[shard]
        t0 = time.perf_counter()
        with _trace.span(
            "sweepdevice/dispatch", "sweepdevice",
            shard=shard, start=start, stop=stop, overlap=overlap_dispatch,
        ):
            wait = torchgrid.to_host_async(_shard(start, stop, ctx))
        return shard, start, stop, t0, wait

    def _complete(entry):
        shard, start, stop, t0, wait = entry
        with _trace.span("sweepdevice/compute", "sweepdevice", shard=shard):
            host = wait()  # waits for this shard's copies only
        secs = time.perf_counter() - t0
        S = stop - start
        reg.counter("sweep/shards").inc()
        reg.counter("sweep/scenarios").inc(S)
        reg.histogram("sweep/shard_seconds").observe(secs)
        with _trace.span(
            "sweepdevice/reduce", "sweepdevice",
            shard=shard, n_scenarios=S, seconds=secs,
        ):
            bc_ml, n_prof, sp_sum, sp_cnt = host[:4]
            bc = bc_ml.sum(axis=0)
            summ = ShardSummary(
                shard=shard, start=start, stop=stop, n_scenarios=S,
                n_points=S * M, seconds=secs,
                scenarios_per_sec=S / secs if secs > 0 else 0.0,
                best_counts={
                    sched.value: int(c)
                    for sched, c in zip(GRID_SCHEDULES, bc) if c
                },
                frac_overlap_profitable=float(n_prof) / (S * M),
                mean_best_speedup=(
                    float(sp_sum) / float(sp_cnt) if sp_cnt else 0.0
                ),
            )
            if collect_stats:
                for j, f in enumerate(fam_of):
                    mom_acc[f] += host[4][j]
                    pts_acc[f] += S
                    bc_acc[f] += bc_ml[j]
            summaries.append(summ)
            if on_shard is not None:
                on_shard(summ)

    pending = None
    for shard in owned:
        start, stop = plan.bounds[shard]
        if start == stop:
            if pending is not None:
                _complete(pending)
                pending = None
            summ = ShardSummary(
                shard, start, stop, 0, 0, 0.0, 0.0, {}, 0.0, 0.0
            )
            summaries.append(summ)
            if on_shard is not None:
                on_shard(summ)
            continue
        entry = _dispatch(shard)
        if pending is not None:
            _complete(pending)
        if overlap_dispatch:
            pending = entry
        else:
            _complete(entry)
            pending = None
    if pending is not None:
        _complete(pending)

    stats = None
    if collect_stats:
        hist = ctx["hist"].cpu().numpy().reshape((len(buckets),) + shape)
        out = []
        for f in range(len(buckets)):
            st = GateStats.empty()
            st.hist = st.hist + hist[f]
            st.moments = st.moments + mom_acc[f]
            st.best_counts = {
                sched.value: int(c)
                for sched, c in zip(GRID_SCHEDULES, bc_acc[f]) if c
            }
            st.n_points = int(pts_acc[f])
            out.append(st)
        stats = dict(zip(buckets, out)) if per_family else out[0]

    result = SweepResult(
        plan=plan, mode="reduce", host_index=host_index,
        host_count=host_count, owned=owned, summaries=tuple(summaries),
        grid=None,
    )
    return stats, result


def device_merge_stats(stats_list, *, device=None):
    """Multi-host :class:`GateStats` merge on the card.

    The histograms of the multi-host stat streams (``sweep_host*.jsonl``)
    are stacked on the card and summed there.  int64 addition is exact
    and associative, so the result is bit-identical to the host-side
    left fold ``functools.reduce(GateStats.merge, stats_list)``.  The
    float moments and the best-count/point tallies are reporting-only
    and tiny; they fold on the host in list order, so even their float
    rounding matches the ``merge`` chain.  (The reference spreads the
    histograms over its devices and ``psum``\\ s them; one card sums
    them in one reduction.)
    """
    from repro_torch.autotune import torchgrid
    from repro_torch.learn.stats import GateStats

    stats_list = list(stats_list)
    dev = resolve_device(device)
    if not stats_list:
        return GateStats.empty()
    first = stats_list[0]
    for other in stats_list[1:]:
        if other.schema != first.schema:
            raise ValueError(
                f"cannot merge GateStats schema {other.schema} "
                f"into schema {first.schema}"
            )
        if other.hist.shape != first.hist.shape:
            raise ValueError("GateStats bin layouts differ")
    stacked = torchgrid.to_device(
        torch.from_numpy(np.stack([s.hist for s in stats_list])), dev)
    hist = stacked.sum(dim=0).cpu().numpy()

    moments = first.moments.copy()
    counts = dict(first.best_counts)
    n_points = first.n_points
    for other in stats_list[1:]:
        moments = moments + other.moments
        for key, v in other.best_counts.items():
            counts[key] = counts.get(key, 0) + v
        n_points += other.n_points
    return GateStats(
        hist=hist,
        moments=moments,
        best_counts=counts,
        n_points=n_points,
        schema=first.schema,
    )


__all__ = [
    "host_batch",
    "host_ragged_batch",
    "device_batch",
    "device_ragged_batch",
    "evaluate_mixed_grid",
    "dispatch_mixed_grid",
    "sweep_device_stats",
    "device_merge_stats",
]
