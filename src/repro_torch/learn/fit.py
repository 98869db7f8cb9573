"""Sim-to-real machine calibration: fit machine parameters to measured
schedule times by gradient descent (port of ``repro.learn.fit``).

The torch grid engine (:mod:`repro_torch.autotune.torchgrid`) is
differentiable by autograd w.r.t. every
:class:`~repro_torch.autotune.torchgrid.MachineArrays` leaf, so closing
the gap between the analytic model and a real deployment is a few Adam
steps: collect ``(gemm, schedule, measured seconds)`` records —
``Autotuner.measure`` persists exactly these — and descend the mean
squared *log*-time error over the fittable parameters (``link_bw``,
``s_half``, the CIL coefficients, ...).  Log-space on both sides keeps
the loss scale-free across microsecond and millisecond operators and
guarantees positive parameters.

Per deployment, the persisted measured tier feeds
:func:`records_from_cache`, :func:`fit_machine` recovers the machine's
effective ``link_bw``/``s_half``/CIL, and the resulting
:class:`FitResult` (a) re-evaluates grids through
``evaluate_grid_raw(..., fit.machine_arrays())`` and (b) persists in the
autotune cache's artifact segment next to the learned gate.

Every entry point that evaluates the grid runs on an explicit ``device``
(``None`` = the card; a host without CUDA raises unless the caller
passes ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.machine import MachineSpec, machine_for_group
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import GemmShape

FIT_SCHEMA_VERSION = 1
FIT_ARTIFACT_KIND = "machine_fit"

# MachineArrays leaves fit_machine may optimize.  All are positive and
# enter the model smoothly; integer/topology leaves are not fittable.
FITTABLE_PARAMS = (
    "link_bw",
    "s_half",
    "hbm_bw",
    "peak_flops",
    "kernel_latency",
    "link_latency",
    "kernel_ramp",
    "cil_gemm_c2",
    "cil_gemm_c3",
    "cil_comm_c2",
    "cil_comm_c3",
)


@dataclasses.dataclass(frozen=True)
class MeasuredRecord:
    """One measured schedule execution (what ``Autotuner.measure`` logs).

    ``profile`` carries the ragged step fractions the execution ran with
    (None = the uniform cut): profile-bearing records route
    :func:`fit_machine` through the ragged grid evaluator so skewed
    ``ficco_a2a_ffn`` timings calibrate the machine too.  ``variant`` is
    the kernel-variant digest for records produced by
    ``Autotuner.measure_variants`` ("" for plain schedule timings).
    """

    gemm: GemmShape
    schedule: Schedule
    seconds: float
    group: int
    profile: tuple[float, ...] | None = None
    variant: str = ""


def records_from_cache(cache, machine_name: str) -> list[MeasuredRecord]:
    """Extract measured-tier records for one machine from the autotune
    decision cache.

    Keys are ``TuneKey`` strings (``machine/gG/mM/nN/kK/bB/profile``);
    machine names may themselves contain ``/`` (the machine-grid
    variants do), so fields parse from the right.  Only uniform-profile
    entries (digest exactly ``u<steps>`` — a *named* skewed profile can
    legitimately start with ``u``) with a recorded ``measured_total_s``
    qualify.
    """
    import re

    out: list[MeasuredRecord] = []
    for key, entry in cache.decision_entries().items():
        t = entry.get("measured_total_s")
        if not t:
            continue
        parts = key.split("/")
        if len(parts) < 7:
            continue
        mach = "/".join(parts[:-6])
        g, m, n, k, b, profile = parts[-6:]
        if mach != machine_name or not re.fullmatch(r"u\d+", profile):
            continue
        try:
            sched = Schedule(entry["schedule"])
            out.append(
                MeasuredRecord(
                    gemm=GemmShape(
                        int(m[1:]), int(n[1:]), int(k[1:]), int(b[1:])
                    ),
                    schedule=sched,
                    seconds=float(t),
                    group=int(g[1:]),
                )
            )
        except (KeyError, ValueError):
            continue
    return out


def variant_records_from_cache(
    cache, machine_name: str, *, kernel: str | None = None
) -> list[MeasuredRecord]:
    """Extract kernel-variant timing records for one machine.

    These are the 8-segment keys ``Autotuner.measure_variants`` writes
    (``machine/gG/mM/nN/kK/bB/profile/vDIGEST``).  Skewed entries carry
    their raw step fractions in the cache entry (``profile_frac``), so
    the returned records rebuild the *ragged* fit objective exactly;
    uniform entries (digest ``u<steps>``) come back with
    ``profile=None``.  ``kernel`` filters to one kernel's records.
    """
    import re

    seg = re.compile(r"vc\d+t\d+x\d+x\d+d\d+[fr]")
    out: list[MeasuredRecord] = []
    for key, entry in cache.decision_entries().items():
        t = entry.get("measured_total_s")
        if not t:
            continue
        parts = key.split("/")
        if len(parts) < 8 or not seg.fullmatch(parts[-1]):
            continue
        mach = "/".join(parts[:-7])
        g, m, n, k, b, profile = parts[-7:-1]
        if mach != machine_name:
            continue
        if kernel is not None and entry.get("kernel") != kernel:
            continue
        frac = entry.get("profile_frac")
        try:
            out.append(
                MeasuredRecord(
                    gemm=GemmShape(
                        int(m[1:]), int(n[1:]), int(k[1:]), int(b[1:])
                    ),
                    schedule=Schedule(entry["schedule"]),
                    seconds=float(t),
                    group=int(g[1:]),
                    profile=(
                        tuple(float(f) for f in frac) if frac else None
                    ),
                    variant=entry.get("variant", parts[-1][1:]),
                )
            )
        except (KeyError, ValueError):
            continue
    return out


def _spec_payload(machine: MachineSpec) -> dict:
    raw = dataclasses.asdict(machine)
    raw["topology"] = machine.topology.value
    return raw


def _spec_from_payload(raw: dict) -> MachineSpec:
    from repro_torch.core.machine import Topology

    fields = dict(raw)
    fields["topology"] = Topology(fields["topology"])
    return MachineSpec(**fields)


@dataclasses.dataclass(frozen=True)
class FitResult:
    """Fitted machine parameters + fit quality.

    ``fitted`` maps parameter name -> fitted value; ``initial`` holds
    the pre-fit values (the analytic model's calibration).  ``loss0`` /
    ``loss`` are mean squared log-time errors before/after.
    ``machine_spec`` is the full spec the fit ran against (a
    machine-grid variant's topology/link counts survive persistence —
    rebuilding from the base registry machine would silently change the
    comm model under the fitted parameters).
    """

    machine: str
    group: int
    params: tuple[str, ...]
    fitted: dict[str, float]
    initial: dict[str, float]
    loss0: float
    loss: float
    n_records: int
    machine_spec: dict = dataclasses.field(default_factory=dict)
    version: int = FIT_SCHEMA_VERSION

    def scale(self, name: str) -> float:
        """fitted/initial ratio — 1.0 means the model was already right."""
        return self.fitted[name] / self.initial[name]

    def spec(self) -> MachineSpec:
        """The exact (pre-fit) MachineSpec the records were fitted on."""
        return _spec_from_payload(self.machine_spec)

    def machine_arrays(self, *, device=None):
        """The fitted :class:`~repro_torch.autotune.torchgrid.MachineArrays`
        (single machine), ready for ``evaluate_grid_raw``."""
        return _patched_arrays(self.spec(), self.fitted, device=device)

    def to_payload(self) -> dict:
        return {
            "version": self.version,
            "machine": self.machine,
            "group": self.group,
            "params": list(self.params),
            "fitted": dict(self.fitted),
            "initial": dict(self.initial),
            "loss0": self.loss0,
            "loss": self.loss,
            "n_records": self.n_records,
            "machine_spec": dict(self.machine_spec),
        }

    @classmethod
    def from_payload(cls, raw: dict) -> "FitResult":
        if raw.get("version") != FIT_SCHEMA_VERSION:
            raise ValueError(
                f"FitResult schema {raw.get('version')!r} != "
                f"{FIT_SCHEMA_VERSION}"
            )
        return cls(
            machine=raw["machine"],
            group=int(raw["group"]),
            params=tuple(raw["params"]),
            fitted={k: float(v) for k, v in raw["fitted"].items()},
            initial={k: float(v) for k, v in raw["initial"].items()},
            loss0=float(raw["loss0"]),
            loss=float(raw["loss"]),
            n_records=int(raw["n_records"]),
            machine_spec=dict(raw["machine_spec"]),
        )


def _patched_arrays(machine: MachineSpec, overrides: dict[str, float], *,
                    device=None):
    from repro_torch.autotune.torchgrid import machine_arrays

    mp = machine_arrays((machine,), device=device)
    return mp._replace(
        **{
            name: torch.tensor([val], dtype=torch.float64,
                               device=mp.peak_flops.device)
            for name, val in overrides.items()
        }
    )


def fit_machine(
    machine: MachineSpec,
    records: Sequence[MeasuredRecord],
    *,
    params: tuple[str, ...] = ("link_bw", "s_half"),
    steps: int = 300,
    lr: float = 0.05,
    device=None,
) -> FitResult:
    """Adam on the torch grid engine: fit ``params`` to measured times.

    Parameters descend in log-space (positivity for free, scale-free
    steps); the loss is the mean squared difference of log model time vs
    log measured time over all records, its gradient by autograd, and the
    optimizer the reference's hand-written Adam (β 0.9 / 0.999, ε 1e-8;
    the best iterate wins).  ``records`` should span a few sizes and
    schedules — a single operator cannot separate bandwidth from latency
    terms.

    Records carrying a ``profile`` (skewed kernel timings) route the
    whole fit through the ragged grid evaluator: every record becomes
    one ragged lane with its own step-fraction row (uniform records get
    the uniform profile), so the objective stays a single differentiable
    ``(schedule, lane)`` gather.
    """
    from repro_torch.autotune.torchgrid import (
        evaluate_grid_raw,
        evaluate_ragged_grid_raw,
        machine_arrays,
    )
    from repro_torch.core.batch import RaggedBatch, ScenarioBatch
    from repro_torch.core.engine import GRID_SCHEDULES
    from repro_torch.core.workload import StepProfile

    for p in params:
        if p not in FITTABLE_PARAMS:
            raise ValueError(
                f"cannot fit {p!r}; fittable: {', '.join(FITTABLE_PARAMS)}"
            )
    records = list(records)
    if not records:
        raise ValueError("no measured records to fit against")
    groups = {r.group for r in records}
    if len(groups) != 1:
        raise ValueError(
            f"records span several group sizes {sorted(groups)}; "
            "fit one (machine, group) at a time"
        )
    eff = machine_for_group(machine, groups.pop())

    sb = ScenarioBatch.from_gemms([r.gemm for r in records])
    ragged = any(r.profile is not None for r in records)
    if ragged:
        profiles = [
            StepProfile(tuple(r.profile))
            if r.profile is not None
            else StepProfile.uniform(eff.group)
            for r in records
        ]
        sb = RaggedBatch.from_batch_and_profiles(sb, profiles)
    targets = np.log(np.asarray([r.seconds for r in records]))
    eval_raw = evaluate_ragged_grid_raw if ragged else evaluate_grid_raw

    mp0 = machine_arrays((eff,), device=device)
    dev = mp0.peak_flops.device
    init = {name: float(getattr(mp0, name)[0]) for name in params}
    t_log = torch.as_tensor(targets, dtype=torch.float64, device=dev)
    s_idx = torch.as_tensor(
        [GRID_SCHEDULES.index(r.schedule) for r in records], device=dev
    )
    l_idx = torch.arange(len(records), device=dev)

    def value_and_grad(log_p):
        log_p = log_p.detach().requires_grad_(True)
        mp = mp0._replace(
            **{
                name: torch.exp(log_p[i])[None]
                for i, name in enumerate(params)
            }
        )
        out = eval_raw(sb, mp, g_max=eff.group)
        total = out[0][0]  # (L, S)
        model = total[s_idx, l_idx]
        loss = torch.mean((torch.log(model) - t_log) ** 2)
        (g,) = torch.autograd.grad(loss, log_p)
        return loss.detach(), g

    log_p = torch.tensor(
        [math.log(init[name]) for name in params], dtype=torch.float64,
        device=dev,
    )
    loss0 = float(value_and_grad(log_p)[0])
    mu = torch.zeros_like(log_p)
    nu = torch.zeros_like(log_p)
    b1, b2, eps = 0.9, 0.999, 1e-8
    best_lp, best_loss = log_p, loss0
    for t in range(1, steps + 1):
        loss, g = value_and_grad(log_p)
        if float(loss) < best_loss:
            best_loss, best_lp = float(loss), log_p
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        mhat = mu / (1 - b1**t)
        nhat = nu / (1 - b2**t)
        log_p = log_p - lr * mhat / (torch.sqrt(nhat) + eps)
    loss, _ = value_and_grad(log_p)
    if float(loss) < best_loss:
        best_loss, best_lp = float(loss), log_p
    fitted = {
        name: float(torch.exp(best_lp[i]))
        for i, name in enumerate(params)
    }
    return FitResult(
        machine=machine.name,
        group=eff.group,
        params=tuple(params),
        fitted=fitted,
        initial=init,
        loss0=loss0,
        loss=best_loss,
        n_records=len(records),
        machine_spec=_spec_payload(eff),
    )


def synthesize_records(
    machine: MachineSpec,
    gemms: Sequence[GemmShape],
    schedules: Sequence[Schedule],
    *,
    overrides: dict[str, float] | None = None,
    noise: float = 0.0,
    seed: int = 0,
    device=None,
) -> list[MeasuredRecord]:
    """Model-generated "measured" times, optionally from a perturbed
    machine — the synthetic ground truth the fit tests recover."""
    from repro_torch.autotune.torchgrid import evaluate_grid_raw
    from repro_torch.core.batch import ScenarioBatch
    from repro_torch.core.engine import GRID_SCHEDULES

    mp = _patched_arrays(machine, overrides or {}, device=device)
    sb = ScenarioBatch.from_gemms(gemms)
    out = evaluate_grid_raw(sb, mp, g_max=machine.group)
    total = out[0][0].cpu().numpy()  # (L, S)
    valid = out[5][0].cpu().numpy()
    rng = np.random.default_rng(seed)
    records = []
    for l, sched in enumerate(GRID_SCHEDULES):
        if sched not in schedules:
            continue
        for i, gemm in enumerate(gemms):
            if not valid[l, i]:
                continue
            t = float(total[l, i])
            if noise:
                t *= float(np.exp(rng.normal(0.0, noise)))
            records.append(
                MeasuredRecord(gemm, sched, t, machine.group)
            )
    return records


class FittedEngine:
    """Engine over the torch grid with one machine's *fitted* parameters.

    The fit-then-retrain bridge: wraps a :class:`FitResult` and patches
    its fitted values into the matching lanes of the packed
    :class:`~repro_torch.autotune.torchgrid.MachineArrays` before
    evaluation, so sweeps — and the
    :class:`~repro_torch.learn.gate.LearnedGate` statistics they produce
    — see the calibrated machine instead of the registry default.
    Machines whose name doesn't match ``fit.machine`` pass through
    untouched, so mixed-machine grids stay meaningful.  ``device``
    defaults to the card.
    """

    name = "fitted"
    supports_ragged = True
    jit = False
    differentiable = False
    trace_safe = False

    def __init__(self, fit: FitResult, *, device=None):
        self.fit = fit
        self.device = device

    def evaluate(
        self,
        scenarios,
        machines,
        *,
        dma: bool = True,
        dma_into_place: bool = False,
        schedules=None,
    ):
        from repro_torch.autotune.torchgrid import (
            _to_host,
            evaluate_grid_raw,
            evaluate_ragged_grid_raw,
            machine_arrays,
        )
        from repro_torch.core import batch as _batch
        from repro_torch.core.engine import (
            GRID_SCHEDULES,
            GridResult,
            as_scenario_sequence,
            is_ragged,
        )

        scenarios = as_scenario_sequence(scenarios)
        ragged = is_ragged(scenarios)
        sb = (
            _batch._as_ragged_batch(scenarios)
            if ragged
            else _batch._as_batch(scenarios)
        )
        machines = tuple(machines)
        schedules = (
            GRID_SCHEDULES if schedules is None else tuple(schedules)
        )
        idx = [
            j for j, mch in enumerate(machines)
            if mch.name == self.fit.machine
        ]
        mp = machine_arrays(machines, device=self.device)
        for name, val in self.fit.fitted.items():
            arr = getattr(mp, name).clone()
            arr[idx] = val
            mp = mp._replace(**{name: arr})
        g_max = max(mch.group for mch in machines)
        raw = (
            evaluate_ragged_grid_raw if ragged else evaluate_grid_raw
        )(
            sb, mp, g_max=g_max, dma=dma,
            dma_into_place=dma_into_place, schedules=schedules,
        )
        return GridResult.from_machine_major(
            _to_host(raw), schedules=schedules, scenarios=sb,
            machines=machines, dma=dma,
        )


# ---------------------------------------------------------------------------
# Persistence (autotune-cache artifact segment).
# ---------------------------------------------------------------------------


def save_fit(fit: FitResult, *, cache=None, name: str | None = None) -> None:
    from repro_torch.autotune.cache import AutotuneCache

    cache = cache if cache is not None else AutotuneCache()
    cache.put_artifact(
        FIT_ARTIFACT_KIND,
        name or f"{fit.machine}/g{fit.group}",
        fit.to_payload(),
    )


def load_fit(name: str, *, cache=None) -> FitResult | None:
    """Load a persisted fit; stale/mismatched artifacts yield None."""
    from repro_torch.autotune.cache import AutotuneCache

    cache = cache if cache is not None else AutotuneCache()
    raw = cache.get_artifact(FIT_ARTIFACT_KIND, name)
    if raw is None:
        return None
    try:
        return FitResult.from_payload(raw)
    except (ValueError, KeyError, TypeError):
        return None


__all__ = [
    "FIT_SCHEMA_VERSION",
    "FIT_ARTIFACT_KIND",
    "FITTABLE_PARAMS",
    "MeasuredRecord",
    "FitResult",
    "FittedEngine",
    "records_from_cache",
    "variant_records_from_cache",
    "fit_machine",
    "synthesize_records",
    "save_fit",
    "load_fit",
]
