"""On-card batched FiCCO grid engine: float64 tensor math + autograd
(port of ``repro.autotune.jaxgrid``).

This is the PyTorch counterpart of ``repro_torch.core.batch``: the
roofline GEMM model, the communication model, the CIL formulas and the
two-channel pipeline, all expressed as tensor math over a ``(machine,
schedule, scenario)`` grid so that

  * a whole sweep runs on the card as one batched evaluation: the machine
    axis the reference ``vmap``\\ s over is a leading tensor dimension
    here (every machine leaf is an ``(M, 1)`` column broadcast against
    the ``(S,)`` scenario arrays);
  * every output is differentiable w.r.t. the machine parameters and the
    heuristic threshold horizon TAU by autograd, which turns threshold
    calibration into a few Adam steps (:func:`calibrate_tau`) and machine
    calibration into a fit (``repro_torch.learn.fit``).

Numerics: the engine runs in float64 and replays the NumPy engine's
accumulation order, so grids agree with
``repro_torch.core.batch.evaluate_grid`` to ~1e-15 relative, far inside
the 1e-9 the tests hold it to.  The kernels are dtype-generic over the
:class:`MachineArrays` float leaves (``machine_arrays(..., dtype=...)``)
with float64 confined to the pipeline's accumulator, as in the
reference.  There is no compiler here: the reference's ``lax.scan`` and
``jit`` become an eager Python loop over ``g_max`` steps on batched
tensors (no ``torch.compile``, no CUDA graph).

Machines with different group sizes batch together by padding every
pipeline to ``g_max`` steps; padded steps carry zero time and a masked
dependency, which leaves totals, busy times and exposed time bit-exact.

Every entry point runs on an explicit ``device``: ``None`` means the
card, and a host without CUDA raises unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``).

Quick start (the whole grid on the card in three lines)::

    from repro_torch.core.engine import get_engine
    grid = get_engine("torch").evaluate(scenarios, machines)
    best = grid.best_idx()
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import inefficiency as ineff
from repro_torch.core.batch import _as_batch, _as_ragged_batch
from repro_torch.core.engine import GRID_SCHEDULES, GridResult
from repro_torch.core.heuristics import MIN_DECOMPOSE_FLOPS
from repro_torch.core.machine import MachineSpec, Topology
from repro_torch.core.schedule_types import STUDIED, Schedule
from repro_torch.device import resolve_device

_F = torch.float64
_I = torch.int64


class MachineArrays(NamedTuple):
    """Struct-of-tensors of M machines (leading axis M).

    The calibrated coefficients (``s_half``, the four CIL coefficients,
    ``mt_ref``) are solved host-side by the NumPy bisections in
    ``repro_torch.core.inefficiency`` — exactly the values the NumPy
    engine uses — and enter the evaluation as ordinary leaves that may
    require grad.
    """

    peak_flops: torch.Tensor
    hbm_bw: torch.Tensor
    link_bw: torch.Tensor
    group: torch.Tensor  # int
    is_mesh: torch.Tensor  # bool: FULL_MESH vs TORUS_RING/SWITCH
    p2p_links: torch.Tensor  # int
    a2a_links: torch.Tensor  # int
    kernel_latency: torch.Tensor
    link_latency: torch.Tensor
    tile_mn: torch.Tensor  # int
    tile_k: torch.Tensor  # int
    parallel_units: torch.Tensor  # int
    kernel_ramp: torch.Tensor
    s_half: torch.Tensor
    cil_gemm_c2: torch.Tensor
    cil_gemm_c3: torch.Tensor
    cil_comm_c2: torch.Tensor
    cil_comm_c3: torch.Tensor
    mt_ref: torch.Tensor


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` (on the host) on ``device`` without waiting for the card.

    A plain host-to-card copy from pageable memory synchronises the
    stream; through pinned memory and ``non_blocking`` it is one more
    queued operation, so a dispatch that packs its operands never waits
    for the work queued before it.
    """
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def machine_arrays(machines, *, dtype=None, device=None) -> MachineArrays:
    """Pack MachineSpecs (plus their host-calibrated coefficients).

    ``dtype`` sets the float leaves' dtype (default float64) — the
    kernels below derive their compute dtype from the machine leaves.
    Integer/bool leaves are dtype-invariant.  ``device`` defaults to the
    card; the leaves reach it without a synchronisation (:func:`to_device`).
    """
    ms = tuple(machines)
    dev = resolve_device(device)
    fdt = _F if dtype is None else dtype

    def leaf(values, dt):
        return to_device(torch.tensor(values, dtype=dt), dev)

    def fa(get):  # float leaf
        return leaf([get(m) for m in ms], fdt)

    def ia(get):  # int leaf
        return leaf([get(m) for m in ms], _I)

    return MachineArrays(
        peak_flops=fa(lambda m: m.peak_flops),
        hbm_bw=fa(lambda m: m.hbm_bw),
        link_bw=fa(lambda m: m.link_bw),
        group=ia(lambda m: m.group),
        is_mesh=leaf([m.topology is Topology.FULL_MESH for m in ms],
                     torch.bool),
        p2p_links=ia(lambda m: m.p2p_links),
        a2a_links=ia(lambda m: m.a2a_links),
        kernel_latency=fa(lambda m: m.kernel_latency),
        link_latency=fa(lambda m: m.link_latency),
        tile_mn=ia(lambda m: m.tile_mn),
        tile_k=ia(lambda m: m.tile_k),
        parallel_units=ia(lambda m: m.parallel_units),
        kernel_ramp=fa(lambda m: m.kernel_ramp),
        s_half=fa(ineff.calibrated_s_half),
        cil_gemm_c2=fa(lambda m: ineff._cil_coeff(m, "gemm", 2)),
        cil_gemm_c3=fa(lambda m: ineff._cil_coeff(m, "gemm", 3)),
        cil_comm_c2=fa(lambda m: ineff._cil_coeff(m, "comm", 2)),
        cil_comm_c3=fa(lambda m: ineff._cil_coeff(m, "comm", 3)),
        mt_ref=fa(ineff._mt_ref),
    )


def scenario_arrays(scenarios, *, device=None) -> tuple[torch.Tensor, ...]:
    """(m, n, k, dtype_bytes) int64 tensors from any scenario form."""
    sb = _as_batch(scenarios)
    dev = resolve_device(device)
    return tuple(
        to_device(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)),
                  dev)
        for a in (sb.m, sb.n, sb.k, sb.dtype_bytes)
    )


def _columns(mp: MachineArrays) -> MachineArrays:
    """Every leaf as an ``(M, 1)`` column: the machine axis broadcasts
    against ``(S,)`` scenario arrays into ``(M, S)`` lanes."""
    return MachineArrays(*(a[:, None] for a in mp))


def _masked(active, x):
    """``where(active, x, 0)``; ``active`` is a mask, or the Python ``True``
    of a step that is always real (the local GEMM)."""
    return x if active is True else torch.where(active, x, 0.0)


# ---------------------------------------------------------------------------
# Roofline GEMM model (port of batch.gemm_exec_vec).
# ---------------------------------------------------------------------------


def _floor_div(a, b):
    """Exact int64 floor-div via float division.

    The substitution is *exact* whenever ``quotient * b < 2**53``: a
    correctly-rounded quotient then sits strictly inside the 1/b gap
    around the true rational, so its floor equals the integer result.
    Every shape field here is far smaller (m <= 2**21, n, k <= 2**16,
    tile counts <= 2**26).
    """
    af = torch.as_tensor(a).to(_F)
    bf = torch.as_tensor(b).to(_F)
    return torch.floor(af / bf).to(_I)


def gemm_exec(m, n, k, b, mp: MachineArrays, *, accumulate=False):
    """Elementwise roofline GEMM time; mirrors ``batch.gemm_exec_vec``.

    The compute dtype follows the machine leaves (float64 by default).
    The explicit casts pin the integer->float promotion points; in
    float64 every cast is exact for the representable shape ranges.
    """
    dt = mp.peak_flops.dtype
    t_mn, pu = mp.tile_mn, mp.parallel_units
    # >= 1 tile even for sub-row ragged chunks (see batch.gemm_exec_vec).
    cm = torch.clamp_min(_floor_div(m + t_mn - 1, t_mn), 1)
    cn = torch.clamp_min(_floor_div(n + t_mn - 1, t_mn), 1)
    tiles = cm * cn
    split_cap = torch.where(m <= t_mn, 2, 8)
    ceil_pu = _floor_div(pu + tiles - 1, torch.clamp_min(tiles, 1))
    splits = torch.minimum(
        torch.minimum(
            ceil_pu, torch.clamp_min(_floor_div(k, mp.tile_k), 1)
        ),
        split_cap,
    )
    splits = torch.where(tiles < pu, splits, 1)
    work = tiles * splits
    padded_flops = 2.0 * ((cm * t_mn) * (cn * t_mn)).to(dt) * k.to(dt)
    occ_quant = work.to(dt) / ((-_floor_div(-work, pu)) * pu).to(dt)
    occ_smooth = torch.clamp_max(work.to(dt) / pu, 1.0)
    occupancy = 0.5 * (occ_quant + occ_smooth)
    k_eff = k.to(dt) / (k + mp.tile_k).to(dt)
    compute = (
        padded_flops / mp.peak_flops / torch.clamp_min(occupancy * k_eff, 1e-9)
    )
    bytes_hbm = (m * k + k * n + m * n).to(dt) * b
    if accumulate:
        bytes_hbm = bytes_hbm + (m * n).to(dt) * b
    bytes_hbm = bytes_hbm + torch.where(
        splits > 1,
        2.0 * (splits - 1).to(dt) * (m * n).to(dt) * 4,
        0.0,
    )
    memory = bytes_hbm / mp.hbm_bw
    base = torch.maximum(compute, memory)
    ramp = mp.kernel_ramp
    t = mp.kernel_latency + base * (1.0 + ramp / (base + ramp))
    return torch.where(m > 0, t, math.nan)


# ---------------------------------------------------------------------------
# Communication model.
# ---------------------------------------------------------------------------


def comm_time(nbytes_per_link, mp: MachineArrays, *, n_transfers=1):
    if isinstance(n_transfers, torch.Tensor):
        per = nbytes_per_link / torch.clamp_min(n_transfers, 1)
    else:
        per = nbytes_per_link / max(n_transfers, 1)
    t_one = mp.link_latency + (per + mp.s_half) / mp.link_bw
    return n_transfers * t_one


def ag_serial_time(mk_bytes, mp: MachineArrays):
    g = mp.group
    per_link = torch.where(
        mp.is_mesh,
        mk_bytes / g,
        mk_bytes * (g - 1) / g / mp.a2a_links,
    )
    return comm_time(per_link, mp)


def p2p_step_time(shard_bytes, mp: MachineArrays):
    return comm_time(shard_bytes / mp.p2p_links, mp)


def a2a_chunk_step_time(chunk_bytes, mp: MachineArrays):
    g = mp.group
    per_link = torch.where(
        mp.is_mesh, chunk_bytes, chunk_bytes * (g - 1) / mp.a2a_links
    )
    n = torch.where(
        mp.is_mesh, 1,
        torch.clamp_min(torch.div(g - 1, mp.a2a_links, rounding_mode="floor"),
                        1),
    )
    return comm_time(per_link, mp, n_transfers=n)


def hbm_move_time(nbytes, mp: MachineArrays):
    return mp.kernel_latency + 2.0 * nbytes / mp.hbm_bw


# ---------------------------------------------------------------------------
# CIL formulas.
# ---------------------------------------------------------------------------


def _mt_norm(m, n, k, b, mp: MachineArrays):
    bytes_mt = (m * k + k * n + m * n).to(mp.mt_ref.dtype) * b
    return bytes_mt / mp.mt_ref


def _cil(mt_p, c2, c3, *, degree: int, dma: bool, rccl_extra):
    c = c2 if min(max(degree, 2), 3) == 2 else c3
    cil = 1.0 + c * (min(degree, 3) - 1) * mt_p
    if degree > 3:
        cil = cil * (1.0 + 0.02 * (degree - 3))
    if not dma:
        cil = cil + rccl_extra
    return cil


def gemm_cil(m, n, k, b, mp, *, degree: int, dma: bool = True):
    mt_p = _mt_norm(m, n, k, b, mp) ** 0.5
    return _cil(
        mt_p, mp.cil_gemm_c2, mp.cil_gemm_c3, degree=degree, dma=dma,
        rccl_extra=ineff.RCCL_EXTRA_GEMM_CIL * mt_p + 0.15,
    )


def comm_cil(m, n, k, b, mp, *, degree: int, dma: bool = True):
    mt_p = _mt_norm(m, n, k, b, mp) ** 0.5
    return _cil(
        mt_p, mp.cil_comm_c2, mp.cil_comm_c3, degree=degree, dma=dma,
        rccl_extra=0.10,
    )


# ---------------------------------------------------------------------------
# Pipeline recurrence, padded to g_max steps.
# ---------------------------------------------------------------------------


def pipeline(comm_steps, compute_steps, deps, comm_active, comp_active):
    """Two-channel pipeline over padded step lists.

    ``comm_steps`` / ``compute_steps`` are length-``g_max``(+1) lists of
    per-lane time tensors; ``*_active`` are matching boolean masks
    (Python bools or tensors) marking real steps.  Inactive steps add
    exactly 0.0 time and never stall, so a group-g machine inside a
    group-``g_max`` padded loop reproduces the unpadded recurrence
    bit-for-bit.

    The loop always **accumulates in float64**, whatever dtype the step
    times arrive in: the recurrence sums ~``g_max`` terms and compares
    running channel clocks, where low-precision cancellation would turn
    stall detection into noise.
    """
    finish = []
    t = None
    for c, a in zip(comm_steps, comm_active):
        c = _masked(a, c).to(_F)
        t = c if t is None else t + c
        finish.append(t)
    zero = torch.zeros_like(compute_steps[0], dtype=_F)
    t_comp = zero
    exposed = zero
    comp_sum = None
    for i, w in enumerate(compute_steps):
        a = comp_active[i]
        w = _masked(a, w).to(_F)
        dep = deps[i]
        if dep is not None:
            ready = finish[dep]
            stalled = ready > t_comp
            if a is not True:
                stalled = a & stalled
            exposed = exposed + torch.where(stalled, ready - t_comp, 0.0)
            t_comp = torch.where(stalled, ready, t_comp)
        t_comp = t_comp + w
        comp_sum = w if comp_sum is None else comp_sum + w
    comm_sum = finish[-1] if finish else zero
    total = torch.maximum(t_comp, comm_sum)
    return total, exposed, comm_sum, comp_sum


def pipeline_closed(comm_steps, compute_steps, deps, comm_active,
                    comp_active):
    """Closed-form pipeline for *uniform* step lists.

    Every uniform-schedule assembly in :func:`_eval_machines` passes one
    repeated tensor per channel (``[t_comm] * g_max``), for which the
    recurrence ``t_j = max(t_{j-1}, finish_j) + w`` has the exact
    solution ``max_j (j*c + remaining_work(j))`` — linear in ``j``, so
    only the endpoint candidates matter.

    The three dep patterns assembled by :func:`_eval_machines` are
    recognised structurally:

      * ``deps[0] is None`` and one extra compute step → local-GEMM
        FiCCO (HF1D/HU1D): ``max(t_l + n*w, c + n*w, n_c*c + w)``;
      * ``deps[0] is None``, equal lengths → SHARD_P2P (first compute
        step free): ``max(n*w, n_c*c + w)``;
      * else plain FiCCO (UF2D/UF1D): ``max(c + n*w, n_c*c + w)``.

    Totals agree with :func:`pipeline` to rounding only — the loop
    accumulates ``j*c`` by repeated addition, the closed form by one
    multiply — so the padded loop remains the bit-exact reference and
    this variant is opt-in (``closed_form=True``).  Ragged schedules
    (per-step distinct times) have no closed form and always loop.
    """

    def count(active):
        # Python bools add as constants: a host value turned into a
        # device tensor would synchronise the stream.  Small integers
        # sum exactly in any order.
        tot, const = None, 0.0
        for a in active:
            if isinstance(a, torch.Tensor):
                v = a.to(_F)
                tot = v if tot is None else tot + v
            else:
                const += float(a)
        if tot is None:
            return torch.full((), const, dtype=_F,
                              device=compute_steps[0].device)
        return tot + const if const else tot

    if comm_steps:
        n_c = count(comm_active)
        c = torch.where(n_c > 0, comm_steps[0], 0.0).to(_F)
    else:  # g_max == 1 SHARD_P2P: no inter-device steps at all
        n_c = torch.zeros((), dtype=_F, device=compute_steps[0].device)
        c = torch.zeros_like(compute_steps[0], dtype=_F)
    comm_sum = n_c * c
    if deps[0] is None and len(compute_steps) == len(comm_steps) + 1:
        t_l = compute_steps[0].to(_F)
        w = compute_steps[1].to(_F)
        n_w = count(comp_active[1:])
        comp_sum = t_l + n_w * w
        t_comp = torch.maximum(
            torch.maximum(t_l + n_w * w, c + n_w * w), comm_sum + w
        )
    elif deps[0] is None:
        w = compute_steps[0].to(_F)
        n_w = count(comp_active)
        comp_sum = n_w * w
        t_comp = torch.maximum(n_w * w, comm_sum + w)
    else:
        w = compute_steps[0].to(_F)
        n_w = count(comp_active)
        comp_sum = n_w * w
        t_comp = torch.maximum(c + n_w * w, comm_sum + w)
    exposed = t_comp - comp_sum
    total = torch.maximum(t_comp, comm_sum)
    return total, exposed, comm_sum, comp_sum


# ---------------------------------------------------------------------------
# Grid evaluation (every machine at once: the machine axis leads).
# ---------------------------------------------------------------------------


class _Rows:
    """Collects one ``(M, S)`` row per schedule and stacks them into the
    machine-major ``(M, L, S)`` / ``(M, L)`` / ``(M, S)`` outputs."""

    def __init__(self, M: int, S: int, device):
        self.shape = (M, S)
        self.M = M
        self.device = device
        self.total, self.comm, self.comp, self.exp = [], [], [], []
        self.steps, self.valid = [], []

    def put(self, ok, total, comm_busy, compute_busy, exposed, n_steps):
        ok = torch.broadcast_to(ok, self.shape)
        for rows, v in ((self.total, total), (self.comm, comm_busy),
                        (self.comp, compute_busy), (self.exp, exposed)):
            rows.append(
                torch.broadcast_to(torch.where(ok, v, math.nan).to(_F),
                                   self.shape)
            )
        if isinstance(n_steps, torch.Tensor):
            self.steps.append(n_steps.reshape(self.M).to(_I))
        else:
            self.steps.append(torch.full((self.M,), int(n_steps), dtype=_I,
                                         device=self.device))
        self.valid.append(ok)

    def stack(self, serial_comm, serial_gemm):
        return (
            torch.stack(self.total, dim=1),
            torch.stack(self.comm, dim=1),
            torch.stack(self.comp, dim=1),
            torch.stack(self.exp, dim=1),
            torch.stack(self.steps, dim=1),
            torch.stack(self.valid, dim=1),
            torch.broadcast_to(serial_comm.to(_F), self.shape),
            torch.broadcast_to(serial_gemm.to(_F), self.shape),
        )


def _eval_machines(m, n, k, b, mp, g_max, schedules, dma, dma_into_place,
                   closed_form=False):
    """All schedules for every machine; returns machine-major stacks.

    ``mp`` holds ``(M,)`` leaves; kernel math runs in the machine leaves'
    dtype and every output row is widened to float64.
    ``closed_form=True`` swaps the padded pipeline loop for
    :func:`pipeline_closed` (equal to rounding); the default stays the
    bit-exact loop.
    """
    pipe = pipeline_closed if closed_form else pipeline
    M = mp.group.shape[0]
    mp = _columns(mp)
    dt = mp.peak_flops.dtype
    g = mp.group
    S = m.shape[0]
    rows_out = _Rows(M, S, m.device)
    true_f = torch.ones((S,), dtype=torch.bool, device=m.device)

    n_q = _floor_div(n, g)
    dev_n = torch.where(n == g * n_q, n_q, n)
    mk_bytes = (m * k).to(dt) * b
    serial_comm = ag_serial_time(mk_bytes, mp)
    serial_gemm = gemm_exec(m, dev_n, k, b, mp)

    m_s = _floor_div(m, g)
    m_div = (m == g * m_s) & (m > 0)
    k_q = _floor_div(k, g)
    k_div = k == g * k_q
    m_sg = _floor_div(m_s, g)

    def step_active(n_steps):
        # Padded loops run g_max iterations; step s is real iff s < n_steps.
        return [s < n_steps for s in range(g_max)]

    for sched in schedules:
        if sched is Schedule.SERIAL:
            rows_out.put(true_f, serial_comm + serial_gemm, serial_comm,
                         serial_gemm, serial_comm, 1)
            continue

        if sched is Schedule.SHARD_P2P:
            shard_bytes = (m_s * k).to(dt) * b
            c_cil = comm_cil(m_s, dev_n, k, b, mp, degree=2, dma=dma)
            g_cil = gemm_cil(m_s, dev_n, k, b, mp, degree=2, dma=dma)
            t_p2p = p2p_step_time(shard_bytes, mp) * c_cil
            t_gemm = gemm_exec(m_s, dev_n, k, b, mp) * g_cil
            total, exposed, comm_sum, comp_sum = pipe(
                [t_p2p] * (g_max - 1),
                [t_gemm] * g_max,
                [None] + list(range(g_max - 1)),
                step_active(g - 1),
                step_active(g),
            )
            rows_out.put(m_div, total, comm_sum, comp_sum, exposed, g)
            continue

        # ---- FiCCO schedules -----------------------------------------
        zeros = torch.zeros((S,), dtype=dt, device=m.device)
        if sched is Schedule.UNIFORM_FUSED_2D:
            k_g = k_q
            chunk_bytes = (m_s * k_g).to(dt) * b
            step = (m, dev_n, k_g)
            gather_bytes = (m * k_g).to(dt) * b
            scatter_bytes = None
            degree, accumulate = 4, True
            local = None
            per_step_gemms = 1
            ok = m_div & k_div
        elif sched is Schedule.UNIFORM_FUSED_1D:
            chunk_bytes = (m_sg * k).to(dt) * b
            step = (m_s, dev_n, k)
            gather_bytes = (m_s * k).to(dt) * b
            scatter_bytes = (m_s * dev_n).to(dt) * b
            degree, accumulate = 4, False
            local = None
            per_step_gemms = 1
            ok = m_div
        elif sched is Schedule.HETERO_FUSED_1D:
            chunk_bytes = (m_sg * k).to(dt) * b
            rows = (g - 1) * m_sg
            step = (rows, dev_n, k)
            gather_bytes = (rows * k).to(dt) * b
            scatter_bytes = (rows * dev_n).to(dt) * b
            degree, accumulate = 3, False
            local = (m_s, dev_n, k)
            per_step_gemms = 1
            ok = m_div & (m_sg >= 1)
        elif sched is Schedule.HETERO_UNFUSED_1D:
            chunk_bytes = (m_sg * k).to(dt) * b
            step = (m_sg, dev_n, k)
            gather_bytes = zeros
            scatter_bytes = ((g - 1) * m_sg * dev_n).to(dt) * b
            degree, accumulate = 2, False
            local = (m_s, dev_n, k)
            per_step_gemms = g - 1
            ok = m_div & (m_sg >= 1)
        else:  # pragma: no cover
            raise ValueError(sched)

        if dma_into_place:
            gather_bytes = zeros
            scatter_bytes = None
            degree = 2
        c_cil = comm_cil(m_s, dev_n, k, b, mp, degree=degree, dma=dma)
        g_cil = gemm_cil(
            step[0], step[1], step[2], b, mp, degree=degree, dma=dma
        )
        t_comm = a2a_chunk_step_time(chunk_bytes, mp) * c_cil
        t_gemm_step = (
            per_step_gemms
            * gemm_exec(
                step[0], step[1], step[2], b, mp, accumulate=accumulate
            )
            * g_cil
        )
        t_gather = torch.where(
            gather_bytes > 0, hbm_move_time(gather_bytes, mp), 0.0
        )
        if scatter_bytes is None:
            t_scatter = zeros
        else:
            t_scatter = torch.where(
                scatter_bytes > 0, hbm_move_time(scatter_bytes, mp), 0.0
            )
        t_step = torch.maximum(t_gemm_step, t_gather + t_scatter)

        if local is not None:
            t_local = gemm_exec(
                local[0], local[1], local[2], b, mp
            ) * gemm_cil(
                local[0], local[1], local[2], b, mp, degree=degree, dma=dma
            )
            compute = [t_local] + [t_step] * g_max
            deps = [None] + list(range(g_max))
            comp_active = [True] + step_active(g)
        else:
            compute = [t_step] * g_max
            deps = list(range(g_max))
            comp_active = step_active(g)
        total, exposed, comm_sum, comp_sum = pipe(
            [t_comm] * g_max, compute, deps, step_active(g), comp_active
        )
        rows_out.put(ok, total, comm_sum, comp_sum, exposed, g)

    return rows_out.stack(serial_comm, serial_gemm)


# ---------------------------------------------------------------------------
# Ragged (non-uniform step) evaluation: padded (S, P) fraction matrix +
# validity masks (mirrors batch.ragged_step_times).
# ---------------------------------------------------------------------------

_FICCO_SET = frozenset(STUDIED)


def ragged_step_times(
    m, n, k, b, frac, mp: MachineArrays, sched: Schedule, *,
    dma: bool = True, dma_into_place: bool = False,
):
    """Per-step stream times for every machine (``mp`` as ``(M, 1)``
    columns); the tensor twin of ``repro_torch.core.batch.ragged_step_times``.

    ``frac`` is the padded ``(S, P)`` fraction matrix.  Returns
    ``(comm_steps, compute_steps, deps, comm_active, comp_active, ok)``
    ready for :func:`pipeline`.
    """
    if sched not in _FICCO_SET:
        raise ValueError(
            f"ragged profiles apply to the FiCCO schedules, got {sched}"
        )
    dt = mp.peak_flops.dtype
    g = mp.group
    S = m.shape[0]
    P = frac.shape[1]
    n_q = _floor_div(n, g)
    dev_n = torch.where(n == g * n_q, n_q, n)
    m_s = _floor_div(m, g)
    m_div = (m == g * m_s) & (m > 0)
    mf = m.to(dt)
    msf = m_s.to(dt)
    kf = k.to(dt)
    zeros = torch.zeros((S,), dtype=dt, device=m.device)

    if sched is Schedule.UNIFORM_FUSED_2D:
        degree, accumulate = 4, True
        local = None
        per_step_gemms = 1
    elif sched is Schedule.UNIFORM_FUSED_1D:
        degree, accumulate = 4, False
        local = None
        per_step_gemms = 1
    elif sched is Schedule.HETERO_FUSED_1D:
        degree, accumulate = 3, False
        local = (m_s, dev_n, k)
        per_step_gemms = 1
    else:  # HETERO_UNFUSED_1D
        degree, accumulate = 2, False
        local = (m_s, dev_n, k)
        per_step_gemms = g - 1
    if dma_into_place:
        degree = 2
    c_cil = comm_cil(m_s, dev_n, k, b, mp, degree=degree, dma=dma)

    comm_steps, compute_steps = [], []
    comm_active, comp_active = [], []
    for s in range(P):
        f = frac[:, s]
        act = f > 0.0
        if sched is Schedule.UNIFORM_FUSED_2D:
            k_s = f * kf
            chunk_bytes = msf * k_s * b
            rows, cols, inner = mf, dev_n, k_s
            gather_bytes = mf * k_s * b
            scatter_bytes = None
        else:
            chunk_bytes = (f * msf) * kf * b
            cols, inner = dev_n, k
            if sched is Schedule.UNIFORM_FUSED_1D:
                rows = f * mf
                gather_bytes = rows * kf * b
                scatter_bytes = rows * dev_n * b
            elif sched is Schedule.HETERO_FUSED_1D:
                rows = f * ((g - 1) * msf)
                gather_bytes = rows * kf * b
                scatter_bytes = rows * dev_n * b
            else:
                rows = f * msf
                gather_bytes = None
                scatter_bytes = (g - 1) * rows * dev_n * b
        if dma_into_place:
            gather_bytes = None
            scatter_bytes = None
        t_comm = a2a_chunk_step_time(chunk_bytes, mp) * c_cil
        g_cil = gemm_cil(
            rows, cols, inner, b, mp, degree=degree, dma=dma
        )
        t_gemm = (
            per_step_gemms
            * gemm_exec(rows, cols, inner, b, mp, accumulate=accumulate)
            * g_cil
        )
        if gather_bytes is None:
            t_gather = zeros
        else:
            t_gather = torch.where(
                gather_bytes > 0, hbm_move_time(gather_bytes, mp), 0.0
            )
        if scatter_bytes is None:
            t_scatter = zeros
        else:
            t_scatter = torch.where(
                scatter_bytes > 0, hbm_move_time(scatter_bytes, mp), 0.0
            )
        t_step = torch.maximum(t_gemm, t_gather + t_scatter)
        comm_steps.append(t_comm)
        comm_active.append(act)
        compute_steps.append(t_step)
        comp_active.append(act)

    if local is not None:
        t_local = gemm_exec(
            local[0], local[1], local[2], b, mp
        ) * gemm_cil(
            local[0], local[1], local[2], b, mp, degree=degree, dma=dma
        )
        compute_steps = [t_local] + compute_steps
        comp_active = [True] + comp_active
        deps: list[int | None] = [None] + list(range(P))
    else:
        deps = list(range(P))
    return comm_steps, compute_steps, deps, comm_active, comp_active, m_div


def _eval_machines_ragged(m, n, k, b, frac, mp, g_max, schedules, dma,
                          dma_into_place):
    """All schedules for every machine over ragged scenarios.

    SERIAL / SHARD_P2P replicate the uniform engine (profile-free); the
    FiCCO schedules run the masked ragged loop over P padded steps.
    """
    M = mp.group.shape[0]
    mp = _columns(mp)
    dt = mp.peak_flops.dtype
    g = mp.group
    S = m.shape[0]
    P = frac.shape[1]
    rows_out = _Rows(M, S, m.device)
    true_f = torch.ones((S,), dtype=torch.bool, device=m.device)

    n_q = _floor_div(n, g)
    dev_n = torch.where(n == g * n_q, n_q, n)
    mk_bytes = (m * k).to(dt) * b
    serial_comm = ag_serial_time(mk_bytes, mp)
    serial_gemm = gemm_exec(m, dev_n, k, b, mp)

    m_s = _floor_div(m, g)
    m_div = (m == g * m_s) & (m > 0)

    def step_active(n_steps):
        return [s < n_steps for s in range(g_max)]

    for sched in schedules:
        if sched is Schedule.SERIAL:
            rows_out.put(true_f, serial_comm + serial_gemm, serial_comm,
                         serial_gemm, serial_comm, 1)
            continue
        if sched is Schedule.SHARD_P2P:
            shard_bytes = (m_s * k).to(dt) * b
            c_cil = comm_cil(m_s, dev_n, k, b, mp, degree=2, dma=dma)
            g_cil = gemm_cil(m_s, dev_n, k, b, mp, degree=2, dma=dma)
            t_p2p = p2p_step_time(shard_bytes, mp) * c_cil
            t_gemm = gemm_exec(m_s, dev_n, k, b, mp) * g_cil
            total, exposed, comm_sum, comp_sum = pipeline(
                [t_p2p] * (g_max - 1),
                [t_gemm] * g_max,
                [None] + list(range(g_max - 1)),
                step_active(g - 1),
                step_active(g),
            )
            rows_out.put(m_div, total, comm_sum, comp_sum, exposed, g)
            continue
        comm, compute, deps, c_act, w_act, ok = ragged_step_times(
            m, n, k, b, frac, mp, sched,
            dma=dma, dma_into_place=dma_into_place,
        )
        total, exposed, comm_sum, comp_sum = pipeline(
            comm, compute, deps, c_act, w_act
        )
        rows_out.put(ok, total, comm_sum, comp_sum, exposed, P)

    return rows_out.stack(serial_comm, serial_gemm)


def _resolve(machines_or_arrays, g_max, device):
    """``(mp, g_max, device)`` from MachineSpecs or packed arrays."""
    if isinstance(machines_or_arrays, MachineArrays):
        mp = machines_or_arrays
        if g_max is None:
            g_max = int(mp.group.max())
        return mp, g_max, mp.peak_flops.device
    ms = tuple(machines_or_arrays)
    mp = machine_arrays(ms, device=device)
    return mp, max(m.group for m in ms), mp.peak_flops.device


def evaluate_ragged_grid_raw(
    scenarios,
    machines_or_arrays,
    *,
    dma: bool = True,
    dma_into_place: bool = False,
    schedules: tuple[Schedule, ...] = GRID_SCHEDULES,
    g_max: int | None = None,
    device=None,
):
    """Ragged grid as device tensors (leading machine axis).

    ``scenarios`` is a RaggedBatch / list of RaggedScenario; the padded
    fraction matrix enters as an ordinary operand.  Packed
    :class:`MachineArrays` carry their own device.
    """
    rb = _as_ragged_batch(scenarios)
    mp, g_max, dev = _resolve(machines_or_arrays, g_max, device)
    m, n, k, b = scenario_arrays(rb, device=dev)
    frac = to_device(
        torch.from_numpy(np.ascontiguousarray(rb.frac, dtype=np.float64)),
        dev,
    ).to(mp.peak_flops.dtype)
    return _eval_machines_ragged(
        m, n, k, b, frac, mp, g_max, tuple(schedules), dma, dma_into_place,
    )


def _to_host(raw):
    return tuple(a.detach().cpu().numpy() for a in raw)


def to_host_async(raw):
    """Start copying device tensors to the host; returns a thunk.

    On the card the copies are queued into pinned memory behind the
    work that produces them and an event marks their end: nothing waits
    until the thunk is called, which then waits for that event only (the
    work queued after it keeps running).  On the CPU the thunk returns
    the arrays at once.
    """
    raw = tuple(a.detach() for a in raw)
    if not raw or raw[0].device.type != "cuda":
        return lambda: tuple(a.cpu().numpy() for a in raw)
    host = tuple(a.to("cpu", non_blocking=True) for a in raw)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return tuple(a.numpy() for a in host)

    return wait


def evaluate_ragged_grid(
    scenarios,
    machines,
    *,
    dma: bool = True,
    dma_into_place: bool = False,
    schedules: tuple[Schedule, ...] = GRID_SCHEDULES,
    device=None,
) -> GridResult:
    """Drop-in replacement for ``batch.evaluate_ragged_grid``."""
    rb = _as_ragged_batch(scenarios)
    machines = tuple(machines)
    out = evaluate_ragged_grid_raw(
        rb, machines, dma=dma, dma_into_place=dma_into_place,
        schedules=schedules, device=device,
    )
    return GridResult.from_machine_major(
        _to_host(out), schedules=schedules, scenarios=rb, machines=machines,
        dma=dma,
    )


def evaluate_grid_raw(
    scenarios,
    machines_or_arrays,
    *,
    dma: bool = True,
    dma_into_place: bool = False,
    schedules: tuple[Schedule, ...] = GRID_SCHEDULES,
    g_max: int | None = None,
    closed_form: bool = False,
    device=None,
):
    """The grid as device tensors (the differentiable entry point).

    Returns ``(total, comm_busy, compute_busy, exposed, steps, valid,
    serial_comm, serial_gemm)`` with leading machine axis ``M`` —
    ``total`` is ``(M, L, S)``.  Accepts either MachineSpecs or an
    already-packed (possibly perturbed) :class:`MachineArrays`, so
    gradients w.r.t. machine parameters flow through unchanged.

    ``closed_form=True`` selects :func:`pipeline_closed` (totals equal to
    the loop up to rounding).
    """
    mp, g_max, dev = _resolve(machines_or_arrays, g_max, device)
    m, n, k, b = scenario_arrays(scenarios, device=dev)
    return _eval_machines(
        m, n, k, b, mp, g_max, tuple(schedules), dma, dma_into_place,
        closed_form,
    )


def evaluate_grid(
    scenarios,
    machines,
    *,
    dma: bool = True,
    dma_into_place: bool = False,
    schedules: tuple[Schedule, ...] = GRID_SCHEDULES,
    device=None,
) -> GridResult:
    """Drop-in replacement for ``repro_torch.core.batch.evaluate_grid``.

    Same :class:`~repro_torch.core.engine.GridResult` out — tensors come
    back from the card and are reshaped to the NumPy engine's ``(L, S,
    M)`` layout, so everything downstream works unchanged.
    """
    sb = _as_batch(scenarios)
    machines = tuple(machines)
    out = evaluate_grid_raw(
        sb, machines, dma=dma, dma_into_place=dma_into_place,
        schedules=schedules, device=device,
    )
    return GridResult.from_machine_major(
        _to_host(out), schedules=schedules, scenarios=sb, machines=machines,
        dma=dma,
    )


# ---------------------------------------------------------------------------
# Differentiable heuristic: soft decision tree over TAU.
# ---------------------------------------------------------------------------

# Index order of the soft pick, matching GRID_SCHEDULES.
_L_SERIAL = GRID_SCHEDULES.index(Schedule.SERIAL)
_L_UF2 = GRID_SCHEDULES.index(Schedule.UNIFORM_FUSED_2D)
_L_UF1 = GRID_SCHEDULES.index(Schedule.UNIFORM_FUSED_1D)
_L_HF1 = GRID_SCHEDULES.index(Schedule.HETERO_FUSED_1D)
_L_HU1 = GRID_SCHEDULES.index(Schedule.HETERO_UNFUSED_1D)


def soft_pick_weights(
    log_tau, m, k, flops, peak_flops, *, temp=0.15, hard_serial=None
):
    """(S, L) schedule weights: the Fig.-12a tree with sigmoid-relaxed
    TAU comparisons.

    Only the two threshold comparisons involve TAU, so only they are
    softened; the serial escapes (tiny-operator guard + learned serial
    gate, passed in as ``hard_serial``) and the M-vs-K branch stay hard.
    As ``temp -> 0`` this converges to ``select_schedule``'s picks.
    """
    metric = flops  # OTB x MT == FLOPs, like the scalar tree
    log_metric = torch.log(metric)
    log_t = log_tau + torch.log(peak_flops)
    # P(metric < T) and P(metric >= 5T), relaxed in log space.
    p_low = torch.sigmoid((log_t - log_metric) / temp)
    p_high = torch.sigmoid((log_metric - (log_t + math.log(5.0))) / temp)
    w_uf1 = p_low
    w_hu1 = (1.0 - p_low) * p_high
    w_hf1 = (1.0 - p_low) * (1.0 - p_high)

    zero = torch.zeros_like(log_metric)
    cols = [zero] * len(GRID_SCHEDULES)
    cols[_L_UF1] = w_uf1
    cols[_L_HU1] = w_hu1
    cols[_L_HF1] = w_hf1
    w = torch.stack(cols, dim=1)
    # Hard branches: 2D when M < K, then the serial escapes (which take
    # precedence over 2D, matching the scalar tree's branch order).
    is_2d = (m < k)[:, None]
    one_hot_2d = torch.zeros_like(w)
    one_hot_2d[:, _L_UF2] = 1.0
    w = torch.where(is_2d, one_hot_2d, w)
    is_serial = (flops < MIN_DECOMPOSE_FLOPS)[:, None]
    if hard_serial is not None:
        is_serial = is_serial | hard_serial[:, None]
    one_hot_ser = torch.zeros_like(w)
    one_hot_ser[:, _L_SERIAL] = 1.0
    return torch.where(is_serial, one_hot_ser, w)


def _tau_loss_inputs(scenarios, machine: MachineSpec, device=None):
    """Host-side precompute: normalized valid totals for one machine."""
    from repro_torch.core.heuristics import (
        machine_serial_gate,
        serial_gate_score_batch,
    )

    sb = _as_batch(scenarios)
    out = evaluate_grid_raw(sb, (machine,), device=device)
    total = out[0][0]  # (L, S)
    valid = out[5][0]
    dev = total.device
    gate_scores = serial_gate_score_batch(
        sb.m, sb.n, sb.k, sb.dtype_bytes, machine
    )
    m, n, k, b = scenario_arrays(sb, device=dev)
    flops = 2.0 * (m * n).to(_F) * k
    best = torch.min(torch.where(valid, total, math.inf), dim=0).values
    # Invalid picks (indivisible decompositions) fall back to serial in
    # the runtime, so charge them the serial time rather than inf/NaN.
    serial = total[_L_SERIAL]
    t_norm = torch.where(valid, total, serial[None, :]) / best[None, :]
    t_norm = t_norm.T  # (S, L)
    peak = torch.tensor(machine.peak_flops, dtype=_F, device=dev)
    hard_serial = torch.as_tensor(
        np.asarray(gate_scores > machine_serial_gate(machine)), device=dev
    )
    return m, k, flops, t_norm, peak, hard_serial


def _tau_loss(log_tau, m, k, flops, t_norm, peak, hard_serial, temp):
    w = soft_pick_weights(
        log_tau, m, k, flops, peak, temp=temp, hard_serial=hard_serial
    )
    return torch.mean(torch.sum(w * t_norm, dim=1))


def expected_heuristic_time(
    tau, scenarios, machine: MachineSpec, *, temp: float = 0.15,
    device=None, _precomputed=None,
):
    """Differentiable mean (soft-)heuristic-picked time, normalized by the
    per-scenario optimum.  ``d(this)/d(tau)`` is finite and nonzero —
    the gradient signal :func:`calibrate_tau` descends.  ``tau`` may be a
    float or a tensor that requires grad.
    """
    if _precomputed is None:
        _precomputed = _tau_loss_inputs(scenarios, machine, device)
    m, k, flops, t_norm, peak, hard = _precomputed
    log_tau = torch.log(torch.as_tensor(tau, dtype=_F, device=m.device))
    return _tau_loss(log_tau, m, k, flops, t_norm, peak, hard, temp)


def calibrate_tau_reference(
    machine: MachineSpec,
    scenarios,
    *,
    temp: float = 0.15,
    lo: float = 1e-4,
    hi: float = 10.0,
    iters: int = 60,
    device=None,
) -> float:
    """Scan + bisection reference for the smooth TAU objective.

    A dense log-spaced scan brackets the global minimum, then bisection
    on the (finite-difference) slope polishes it — the discrete analogue
    the gradient calibration must reproduce.
    """
    pre = _tau_loss_inputs(scenarios, machine, device)
    m, k, flops, t_norm, peak, hard = pre

    def f(lt: float) -> float:
        return float(_tau_loss(
            torch.tensor(lt, dtype=_F, device=m.device), m, k, flops,
            t_norm, peak, hard, temp,
        ))

    taus = np.geomspace(lo, hi, 512)
    losses = np.array([f(math.log(t)) for t in taus])
    i = int(np.argmin(losses))
    llo = math.log(taus[max(i - 1, 0)])
    lhi = math.log(taus[min(i + 1, len(taus) - 1)])
    eps = 1e-4

    def slope(lt: float) -> float:
        return (f(lt + eps) - f(lt - eps)) / (2 * eps)

    for _ in range(iters):
        mid = 0.5 * (llo + lhi)
        if slope(mid) < 0.0:
            llo = mid
        else:
            lhi = mid
    return math.exp(0.5 * (llo + lhi))


def calibrate_tau(
    machine: MachineSpec,
    scenarios,
    *,
    steps: int = 120,
    lr: float = 0.08,
    temp: float = 0.15,
    inits=(0.002, 0.02, 0.2, 1.0),
    device=None,
) -> float:
    """Gradient TAU calibration: a few Adam steps on the soft tree loss.

    First-order descent on :func:`expected_heuristic_time` with the
    reference's hand-written Adam (β 0.9 / 0.999, ε 1e-8), gradients by
    autograd — multi-start (the 1-D landscape can have shoulders), best
    final loss wins.  The result lands on the bisection reference
    (:func:`calibrate_tau_reference`) to well within 5%.
    """
    pre = _tau_loss_inputs(scenarios, machine, device)
    m, k, flops, t_norm, peak, hard = pre

    def value_and_grad(lt):
        lt = lt.detach().requires_grad_(True)
        loss = _tau_loss(lt, m, k, flops, t_norm, peak, hard, temp)
        (g,) = torch.autograd.grad(loss, lt)
        return loss.detach(), g

    def adam(log_tau0: float) -> tuple[float, float]:
        lt = torch.tensor(log_tau0, dtype=_F, device=m.device)
        mu = torch.zeros((), dtype=_F, device=m.device)
        nu = torch.zeros((), dtype=_F, device=m.device)
        b1, b2, eps = 0.9, 0.999, 1e-8
        for t in range(1, steps + 1):
            _, g = value_and_grad(lt)
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            mhat = mu / (1 - b1**t)
            nhat = nu / (1 - b2**t)
            lt = lt - lr * mhat / (torch.sqrt(nhat) + eps)
        loss, _ = value_and_grad(lt)
        return float(lt), float(loss)

    results = [adam(math.log(t0)) for t0 in inits]
    best_lt, _ = min(results, key=lambda r: r[1])
    return math.exp(best_lt)


def shortlist(
    gemm,
    machine: MachineSpec,
    *,
    top: int = 3,
    dma: bool = True,
    backend: str = "numpy",
    profile=None,
    engine=None,
) -> list[tuple[Schedule, float]]:
    """Top-``top`` valid schedules for one GEMM, fastest first.

    A thin alias of :func:`repro_torch.core.engine.shortlist`: ``backend``
    names any engine in the registry (``"torch"`` ranks on the card;
    the default ``"numpy"`` keeps one GEMM's ranking on the host, where
    the reference's alias defaults to ``"jax"``), ``engine=`` passes an
    instance.  ``profile`` ranks the schedules under a ragged step
    profile instead of the uniform split.
    """
    from repro_torch.core.engine import shortlist as _shortlist

    return _shortlist(
        gemm, machine, top=top, dma=dma, backend=backend, profile=profile,
        engine=engine,
    )


__all__ = [
    "MachineArrays",
    "machine_arrays",
    "scenario_arrays",
    "to_device",
    "to_host_async",
    "evaluate_grid",
    "evaluate_grid_raw",
    "evaluate_ragged_grid",
    "evaluate_ragged_grid_raw",
    "ragged_step_times",
    "gemm_exec",
    "comm_time",
    "ag_serial_time",
    "p2p_step_time",
    "a2a_chunk_step_time",
    "hbm_move_time",
    "gemm_cil",
    "comm_cil",
    "pipeline",
    "pipeline_closed",
    "soft_pick_weights",
    "expected_heuristic_time",
    "calibrate_tau",
    "calibrate_tau_reference",
    "shortlist",
]
