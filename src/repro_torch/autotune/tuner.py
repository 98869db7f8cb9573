"""Runtime schedule autotuner: analytic shortlist -> (optional) measure
-> persistent record.

Port of ``repro.autotune.tuner``.  The machine defaults to
:data:`~repro_torch.core.machine.H100_SXM` (the machine ``ficco_linear``
decides for), the analytic tier ranks with the ``"numpy"`` engine of
:mod:`repro_torch.core.engine` by default (where the reference defaults to
its jitted ``"jax"`` engine; ``backend="torch"`` ranks on the card), the
measured tier times the port's schedules over a logical group's stacked
ranks with CUDA events, and the heuristic fallback consults the learned
gate of :mod:`repro_torch.learn` ahead of the scalar gate.

The paper's heuristic picks a schedule from static GEMM signals alone
(~81% of unseen scenarios within 5%).  The autotuner closes the rest of
the gap at runtime, in three escalating tiers:

  1. **cache hit** — a previous process already tuned this
     ``(machine, group, M, N, K, dtype)`` key: zero cost.
  2. **analytic** — the batched cost model (:mod:`repro_torch.core.batch`)
     ranks all schedules for the key in one call; the winner is
     recorded.  This is strictly better-informed than the static decision
     tree (it sees the full simulated pipeline, not two thresholds) at
     microseconds of cost.
  3. **measured** — for keys worth it (long-lived serving configs), time
     the analytic shortlist's top candidates with real executions of the
     ``repro_torch.overlap.schedules`` and record the empirical winner.

Decisions persist via :class:`repro_torch.autotune.cache.AutotuneCache`,
so tier 2/3 run once per key per (machine, torch, CUDA, card) — every
later process starts at tier 1.  ``ficco_linear(schedule="autotune")`` is the
integration point; ``select_schedule`` remains the zero-cost fallback
whenever anything here fails.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from repro_torch.core.heuristics import select_schedule
from repro_torch.core.machine import H100_SXM, MachineSpec, machine_for_group
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import GemmShape
from repro_torch.obs import audit as _audit
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import signature as _signature
from repro_torch.obs import trace as _trace

from repro_torch.autotune.cache import AutotuneCache


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """Cache identity of one data-dependent AG->GEMM site.

    ``profile`` is the ragged step-profile digest
    (:meth:`repro_torch.core.workload.StepProfile.digest`): ``uG`` for the
    paper's uniform G-step split, a name+hash for skewed profiles.  Its
    arrival is the schema-v2 key change — see ``repro_torch.autotune.cache``.

    ``variant`` is the optional trailing kernel-variant segment
    (:attr:`repro_torch.tune.KernelVariant.key_segment`, ``v`` + digest).
    A non-empty variant makes the key an 8-segment *variant-timing* record
    — per-variant measurements feeding the reference's ``learn.fit`` —
    while the 7-segment keys stay the schedule-decision records every
    existing consumer parses (they skip variant keys structurally: the
    extra segment lands in the profile slot and fails the ``u\\d+``
    filter).
    """

    machine: str
    group: int
    m: int
    n: int
    k: int
    dtype_bytes: int
    profile: str = "uniform"
    variant: str = ""

    def __str__(self) -> str:
        base = (
            f"{self.machine}/g{self.group}/m{self.m}/n{self.n}"
            f"/k{self.k}/b{self.dtype_bytes}/{self.profile}"
        )
        return f"{base}/{self.variant}" if self.variant else base

    @classmethod
    def for_gemm(
        cls,
        gemm: GemmShape,
        machine: MachineSpec,
        group: int | None = None,
        profile=None,
        variant=None,
    ) -> "TuneKey":
        g = int(group if group is not None else machine.group)
        if variant is None:
            vseg = ""
        elif isinstance(variant, str):
            vseg = variant if variant.startswith("v") else "v" + variant
        else:
            vseg = variant.key_segment
        return cls(
            machine=machine.name,
            group=g,
            m=gemm.m,
            n=gemm.n,
            k=gemm.k,
            dtype_bytes=gemm.dtype_bytes,
            profile=f"u{g}" if profile is None else profile.digest(),
            variant=vseg,
        )


@dataclasses.dataclass(frozen=True)
class TuneDecision:
    """One schedule decision plus its provenance.

    ``key`` is the :class:`TuneKey` string the decision was made under
    (None only for pre-provenance constructions), ``shortlist`` the
    analytic ranking consulted — ``(schedule value, modelled seconds)``
    pairs, empty when no ranking ran (cache hit, heuristic fallback) —
    and ``gate`` the learned-gate verdict behind a heuristic decision
    (``{"kind": ..., "metric": ..., "threshold": ..., "reason": ...}``).
    Where a learned gate resolves, an analytic decision carries its
    verdict too, with the schedule the gated tree would have picked
    (``"schedule"``) beside the analytic winner: the reference records
    none there.
    """

    schedule: Schedule
    source: str  # "cache" | "analytic" | "measured" | "heuristic"
    model_total_s: float | None = None
    measured_total_s: float | None = None
    key: str | None = None
    shortlist: tuple = ()
    gate: dict | None = None


def _runtime_executable(gemm: GemmShape, group: int, sched: Schedule) -> bool:
    """Can ``ficco_linear`` actually run this schedule for this shape?

    Mirrors the runtime's ``overlap.api._divisible`` guard (the 1D FiCCO
    schedules chunk the per-device shard one level deeper than the cost
    model's validity mask requires).
    """
    from repro_torch.overlap.api import _divisible  # lazy: import cycle

    if gemm.m % group:  # the group cannot even row-shard the operand
        return sched is Schedule.SERIAL
    return _divisible(gemm.m // group, gemm.k, group, sched)


def _time_min(fn, iters: int) -> float:
    """Seconds of ``fn``'s fastest run of ``iters`` after one warm-up run:
    between two CUDA events when ``fn`` returns a CUDA tensor (device
    time), else on the host's ``perf_counter``."""
    out = fn()  # warm
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
        best = float("inf")
        for _ in range(max(1, iters)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    best = float("inf")
    for _ in range(max(1, iters)):
        t1 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t1)
    return best


class Autotuner:
    """Tiered schedule selection with a persistent decision store.

    ``backend`` names the analytic engine in the
    :mod:`repro_torch.core.engine` registry: ``"numpy"`` (default),
    ``"torch"`` (on the card), ``"scalar"`` or any registered third-party
    engine (the reference's default, ``"jax"``, is not a registered name
    here: naming it raises the unknown-engine error).  Every decision —
    including analytic ones — is recorded, so a repeated query costs one
    dict lookup.  ``gate=`` pins a learned serial gate
    (:class:`repro_torch.learn.gate.LearnedGate`) for the heuristic
    fallback; see :meth:`learned_gate` for the resolution order.
    """

    def __init__(
        self,
        cache: AutotuneCache | None = None,
        *,
        backend: str = "numpy",
        persist: bool | str = True,
        gate=None,
        audit=None,
    ):
        from repro_torch.core.engine import get_engine

        get_engine(backend)  # fail fast: ValueError lists valid engines
        self.cache = cache if cache is not None else AutotuneCache()
        self.backend = backend
        # True = eager save per decision, False = in-memory only,
        # "defer" = batched persistence (cache.flush() / atexit) — the
        # serving hot path's choice.
        self.persist = persist
        self.hits = 0
        self.misses = 0
        # Decision-audit destination: an AuditLog pins it, None defers
        # to the process-wide log (repro_torch.obs.audit — re-checked every
        # decision, so REPRO_AUTOTUNE_AUDIT/enable_audit() apply to
        # already-built tuners), False disables auditing for this tuner
        # (the offline replayer uses this so replays never append to
        # the log being replayed).
        self._audit = audit
        self._gate = gate
        # Artifact gates load lazily, once per artifact name ("default"
        # plus one "machine:<family>" slot per family queried).
        self._artifact_gates: dict = {}

    def set_gate(self, gate) -> None:
        """Atomically swap the explicit learned gate this tuner consults.

        One attribute store (atomic under the GIL), so a background
        re-fit thread can install a freshly trained gate while request
        threads are mid-``pick`` — each pick sees either the old or the
        new gate, never a torn state.  ``None`` reverts to the ambient
        gate resolution order (see :meth:`learned_gate`).
        """
        self._gate = gate

    @property
    def gate(self):
        """The explicitly installed gate (``set_gate``), or ``None``."""
        return self._gate

    # -- observability ---------------------------------------------------

    def _audit_log(self):
        if self._audit is False:
            return None
        if self._audit is not None:
            return self._audit
        return _audit.get_audit()

    def _observe(self, kind: str, key: TuneKey, dec: TuneDecision,
                 seconds: float, *, gemm=None, machine=None,
                 group=None, profile=None) -> None:
        """Metrics + audit + signature attribution for one decision.
        Never raises — the tuner's never-raise contract outranks
        observability.

        ``gemm``/``machine``/``group``/``profile`` carry the live
        scenario objects to the signature stream: the :class:`TuneKey`
        alone cannot reconstruct a ragged step profile (digests are
        one-way), so attribution takes the originals.
        """
        try:
            reg = _metrics.get_metrics()
            reg.counter("tuner/decisions").inc()
            reg.counter(f"tuner/pick.{dec.source}").inc()
            reg.histogram("tuner/pick_seconds").observe(seconds)
            stream = _signature.get_signatures()
            if stream is not None and gemm is not None and machine is not None:
                stream.observe_decision(
                    gemm, machine, dec.schedule,
                    group=group, profile=profile, source=dec.source,
                    model_total_s=dec.model_total_s,
                    measured_total_s=dec.measured_total_s,
                )
            log = self._audit_log()
            if log is not None:
                log.record({
                    "kind": kind,
                    "key": str(key),
                    "machine": key.machine,
                    "group": key.group,
                    "m": key.m,
                    "n": key.n,
                    "k": key.k,
                    "dtype_bytes": key.dtype_bytes,
                    "profile": key.profile,
                    "schedule": dec.schedule.value,
                    "source": dec.source,
                    "model_total_s": dec.model_total_s,
                    "measured_total_s": dec.measured_total_s,
                    "shortlist": list(dec.shortlist),
                    "gate": dec.gate,
                })
        except Exception:  # pragma: no cover - observability best-effort
            pass

    def learned_gate(self, machine=None):
        """The learned serial-gate family this tuner's fallback consults.

        Resolution order: explicit ``gate=`` constructor argument, the
        process-wide gates (``repro_torch.learn.gate`` — the ``machine``'s
        family gate first, then the global default; both re-checked on
        every call, so installing or clearing one after this tuner was
        built takes effect immediately), then gates persisted in this
        cache's artifact segment (family slot ahead of the default
        slot, each loaded once).  The learned family takes precedence
        over the hand-tuned scalar gate inside ``select_schedule``;
        None means "no learned gate" and the scalar gate applies as
        before.
        """
        if self._gate is not None:
            return self._gate
        try:
            from repro_torch.learn import gate as _gate_mod
        except Exception:  # pragma: no cover - learn is a sibling package
            return None
        if machine is not None:
            fam = _gate_mod.get_machine_gate(machine)
            if fam is not None:
                return fam
        ambient = _gate_mod.get_default_gate()
        if ambient is not None:
            return ambient
        names = ["default"]
        if machine is not None:
            names.insert(
                0,
                _gate_mod.MACHINE_GATE_PREFIX
                + _gate_mod.machine_family(machine),
            )
        for name in names:
            if name not in self._artifact_gates:
                try:
                    self._artifact_gates[name] = _gate_mod.load_gate(
                        cache=self.cache, name=name
                    )
                except Exception:
                    self._artifact_gates[name] = None
            if self._artifact_gates[name] is not None:
                return self._artifact_gates[name]
        return None

    # -- tier 1+2: cache / analytic ------------------------------------

    def pick(
        self,
        gemm: GemmShape,
        machine: MachineSpec | None = None,
        *,
        group: int | None = None,
        profile=None,
    ) -> TuneDecision:
        """Cached winner if present, else the best *executable* analytic
        winner (recorded).

        The cost model's validity mask (global M divisible by the group)
        is weaker than the runtime chunking rule for the 1D FiCCO
        schedules (the per-device shard must split again: M/g % g == 0),
        so the ranking is filtered through the same ``_divisible`` check
        ``ficco_linear`` applies — a persisted winner is always one the
        runtime will actually execute, never silently swapped for serial.

        ``profile`` tunes for a ragged step profile (capacity-skewed EP
        dispatch): the decision is keyed and ranked per profile digest,
        so a hot-expert skew and the uniform split coexist in the cache.

        Never raises: any model/backend failure degrades to the static
        heuristic (``select_schedule``) — the zero-cost fallback — and
        that decision is *not* persisted, so a healthy later process
        re-tunes.
        """
        machine = machine or H100_SXM
        tkey = TuneKey.for_gemm(gemm, machine, group, profile=profile)
        key = str(tkey)
        t0 = time.perf_counter()
        with _trace.span("tuner/pick", "autotune", key=key) as sp:
            dec = self._pick_impl(gemm, machine, key, group, profile)
            sp.set(
                tier=dec.source,
                schedule=dec.schedule.value,
                cache="hit" if dec.source == "cache" else "miss",
                shortlist=[[s, t] for s, t in dec.shortlist],
                **({"gate": dec.gate} if dec.gate is not None else {}),
            )
        self._observe(
            "pick", tkey, dec, time.perf_counter() - t0,
            gemm=gemm, machine=machine, group=group, profile=profile,
        )
        return dec

    def _pick_impl(
        self, gemm, machine, key: str, group, profile
    ) -> TuneDecision:
        hit = self.cache.get(key)
        if hit is not None:
            try:
                sched = Schedule(hit["schedule"])
            except (KeyError, ValueError):
                sched = None
            if sched is not None:
                self.hits += 1
                return TuneDecision(
                    sched,
                    "cache",
                    hit.get("model_total_s"),
                    hit.get("measured_total_s"),
                    key=key,
                )
        self.misses += 1
        eff = machine_for_group(machine, group) if group else machine
        try:
            ranked = self.executable_ranking(gemm, eff, profile=profile)
            sched, model_t = ranked[0]  # serial always survives the filter
        except Exception:
            # Zero-cost fallback, against the group-retargeted machine so
            # the decision tree + serial gate see the real group size;
            # a learned gate (sweep-trained threshold family) is
            # consulted ahead of the hand-tuned scalar gate.  The
            # never-raise contract outranks the gate: a malformed gate
            # artifact degrades to the scalar-gated tree.
            gate_info = None
            try:
                gate = self.learned_gate(eff)
                dec = select_schedule(gemm, eff, profile=profile, gate=gate)
                gate_info = {
                    "kind": type(gate).__name__ if gate is not None else None,
                    "metric": dec.metric,
                    "threshold": dec.threshold,
                    "reason": dec.reason,
                }
            except Exception:
                dec = select_schedule(gemm, eff, profile=profile)
                gate_info = {
                    "kind": None,
                    "metric": dec.metric,
                    "threshold": dec.threshold,
                    "reason": dec.reason,
                }
            return TuneDecision(
                dec.schedule, "heuristic", key=key, gate=gate_info
            )
        self._record(key, sched, "analytic", model_total_s=model_t)
        return TuneDecision(
            sched, "analytic", model_t, key=key,
            shortlist=tuple((s.value, float(t)) for s, t in ranked[:3]),
            gate=self._gate_verdict(gemm, eff, profile),
        )

    def _gate_verdict(self, gemm, machine, profile):
        """What the learned gate's tree picks beside an analytic decision,
        or None when no learned gate resolves (or it fails: never raises)."""
        try:
            gate = self.learned_gate(machine)
            if gate is None:
                return None
            dec = select_schedule(gemm, machine, profile=profile, gate=gate)
        except Exception:
            return None
        return {
            "kind": type(gate).__name__,
            "metric": dec.metric,
            "threshold": dec.threshold,
            "reason": dec.reason,
            "schedule": dec.schedule.value,
        }

    def executable_ranking(
        self,
        gemm: GemmShape,
        machine: MachineSpec,
        *,
        group: int | None = None,
        profile=None,
    ) -> list[tuple[Schedule, float]]:
        """Full analytic ranking filtered to runtime-executable schedules.

        Uniform AG->GEMM path: ficco_linear chunks the shard one level
        deeper, so the ranking is filtered by its divisibility rule.
        Ragged picks go to the profile-quantized kernel path
        (ficco_a2a_ffn), which handles arbitrary chunk sizes — the cost
        model's own validity mask already applied.  Shared by
        ``_pick_impl`` and the adaptive serving tier
        (:mod:`repro_torch.serve.adapt`), so an online re-rank can never
        pick a schedule the runtime would refuse.
        """
        eff = machine_for_group(machine, group) if group else machine
        ranked = self._shortlist(gemm, eff, top=None, profile=profile)
        if profile is None:
            ranked = [
                (s, t) for s, t in ranked
                if _runtime_executable(gemm, eff.group, s)
            ]
        return ranked

    def shortlist(
        self,
        gemm: GemmShape,
        machine: MachineSpec | None = None,
        *,
        group: int | None = None,
        top: int = 3,
        profile=None,
    ) -> list[tuple[Schedule, float]]:
        """Analytic top-``top`` candidates (schedule, modelled seconds)."""
        machine = machine or H100_SXM
        eff = machine_for_group(machine, group) if group else machine
        return self._shortlist(gemm, eff, top=top, profile=profile)

    def _shortlist(self, gemm, machine, *, top, profile=None):
        from repro_torch.core import engine as _engine

        if top is None:
            top = len(_engine.GRID_SCHEDULES)
        # Eager PyTorch traces nothing, so no trace-time engine swap.
        eng = _engine.get_engine(self.backend)
        with _trace.span(
            "tuner/shortlist", "autotune", engine=eng.name, top=top
        ) as sp:
            out = _engine.shortlist(
                gemm, machine, top=top, engine=eng, profile=profile
            )
            sp.set(ranking=[[s.value, float(t)] for s, t in out])
        if not out:
            raise ValueError(f"no valid schedule for {gemm}")
        return out

    # -- tier 3: measured ----------------------------------------------

    def measure(
        self,
        x: torch.Tensor,
        w: torch.Tensor,
        *,
        machine: MachineSpec | None = None,
        schedules: Sequence[Schedule] | None = None,
        iters: int = 3,
    ) -> TuneDecision:
        """Time real executions of the shortlist and record the winner.

        ``x`` (g, m_s, K) and ``w`` (g, K, n_local) are the stacked shards
        ``ficco_linear`` takes; the key is the global (g·m_s, g·n_local,
        K) GEMM's.  Each candidate runs once to warm up, then ``iters``
        times; its time is the minimum — device time between two CUDA
        events on a CUDA tensor, host ``perf_counter`` time on the CPU.
        Candidates the runtime would not chunk (``_divisible``) are
        dropped before timing; an error a candidate raises propagates.
        The winner is persisted with ``source="measured"``, which tier-1
        lookups prefer forever after.
        """
        from repro_torch.overlap.api import _divisible
        from repro_torch.overlap.schedules import SCHEDULE_FNS

        machine = machine or H100_SXM
        g, m_s, k = x.shape
        n = w.shape[-1] * g
        gemm = GemmShape(g * m_s, n, k, x.element_size())
        tkey = TuneKey.for_gemm(gemm, machine, g)
        key = str(tkey)
        t0 = time.perf_counter()

        if schedules is None:
            try:
                ranked = self.shortlist(gemm, machine, group=g, top=3)
                schedules = [s for s, _ in ranked]
            except Exception:
                schedules = [Schedule.SERIAL]
        candidates = [
            s for s in schedules if _divisible(m_s, k, g, s)
        ] or [Schedule.SERIAL]

        timings: dict[Schedule, float] = {}
        for sched in candidates:
            fn = SCHEDULE_FNS[sched]
            with _trace.span(
                "tuner/measure_candidate", "autotune",
                key=key, schedule=sched.value,
            ) as sp:
                best = _time_min(lambda: fn(x, w), iters)
                timings[sched] = best
                sp.set(seconds=best)

        winner = min(timings, key=timings.get)
        self._record(
            key, winner, "measured", measured_total_s=timings[winner]
        )
        dec = TuneDecision(
            winner, "measured", measured_total_s=timings[winner], key=key,
            shortlist=tuple(
                (s.value, float(t))
                for s, t in sorted(timings.items(), key=lambda kv: kv[1])
            ),
        )
        try:
            _metrics.get_metrics().counter("tuner/measure").inc()
        except Exception:  # pragma: no cover
            pass
        self._observe(
            "measure", tkey, dec, time.perf_counter() - t0,
            gemm=gemm, machine=machine, group=g,
        )
        return dec

    def measure_variants(
        self,
        kernel: str,
        gemm: GemmShape,
        variants,
        *,
        machine: MachineSpec | None = None,
        group: int | None = None,
        profile=None,
        runner=None,
        iters: int = 1,
    ) -> list[tuple]:
        """Time kernel variants and persist variant-keyed records.

        ``runner(variant) -> seconds`` measures for real (the caller owns
        the sharded operands); with ``runner=None`` the deterministic
        discrete-event cost model (:mod:`repro_torch.tune.cost`) stands in
        — still variant-sensitive through wave quantization and the
        buffer-depth recurrence.

        Every variant's time lands at the 8-segment variant-keyed
        :class:`TuneKey` with the kernel name, variant digest, and (for
        skewed profiles) the raw step fractions in the entry, so the
        reference's ``learn.fit.variant_records_from_cache`` can rebuild
        the fit objective — including the ragged one — from the cache
        alone.
        Returns ``[(variant, seconds), ...]`` in input order.
        """
        from repro_torch.tune.cost import variant_cost
        from repro_torch.tune.variants import KERNEL_SCHEDULE

        machine = machine or H100_SXM
        g = int(group if group is not None else machine.group)
        sched = KERNEL_SCHEDULE[kernel]
        out: list[tuple] = []
        for variant in variants:
            if runner is not None:
                best = float("inf")
                for _ in range(max(1, iters)):
                    best = min(best, float(runner(variant)))
                source = "measured"
            else:
                best = float(
                    variant_cost(
                        variant, gemm, machine, group=g, profile=profile
                    )
                )
                source = "variant-model"
            key = str(
                TuneKey.for_gemm(
                    gemm, machine, g, profile=profile, variant=variant
                )
            )
            entry = {
                "schedule": sched.value,
                "source": source,
                "model_total_s": None if runner is not None else best,
                "measured_total_s": best,
                "kernel": kernel,
                "variant": variant.digest(),
            }
            if profile is not None:
                entry["profile_frac"] = [
                    float(f) for f in profile.trimmed().fractions
                ]
            self.cache.put(key, entry, persist=self.persist)
            out.append((variant, best))
        try:
            _metrics.get_metrics().counter("tuner/measure_variants").inc(
                len(out)
            )
        except Exception:  # pragma: no cover
            pass
        return out

    # -- bookkeeping ----------------------------------------------------

    def _record(
        self,
        key: str,
        schedule: Schedule,
        source: str,
        *,
        model_total_s: float | None = None,
        measured_total_s: float | None = None,
    ) -> None:
        self.cache.put(
            key,
            {
                "schedule": schedule.value,
                "source": source,
                "model_total_s": model_total_s,
                "measured_total_s": measured_total_s,
            },
            persist=self.persist,
        )

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


# ---------------------------------------------------------------------------
# Process-wide tuner (what ``ficco_linear(schedule="autotune")`` consults).
# ---------------------------------------------------------------------------

_GLOBAL_TUNER: Autotuner | None = None


def get_tuner() -> Autotuner:
    global _GLOBAL_TUNER
    if _GLOBAL_TUNER is None:
        _GLOBAL_TUNER = Autotuner()
    return _GLOBAL_TUNER


def set_tuner(tuner: Autotuner | None) -> None:
    global _GLOBAL_TUNER
    _GLOBAL_TUNER = tuner


def reset_tuner() -> None:
    """Drop the global tuner (e.g. after changing the cache env var)."""
    set_tuner(None)


def autotune_schedule(
    m: int,
    n: int,
    k: int,
    *,
    machine: MachineSpec | None = None,
    group: int | None = None,
    dtype_bytes: int = 2,
    profile=None,
) -> Schedule:
    """One-call convenience: tuned schedule for a global (M, N, K) GEMM.

    ``profile`` (a :class:`~repro_torch.core.workload.StepProfile`) tunes for
    a ragged (e.g. capacity-skewed EP) step decomposition.
    """
    return get_tuner().pick(
        GemmShape(m, n, k, dtype_bytes), machine, group=group,
        profile=profile,
    ).schedule


__all__ = [
    "TuneKey",
    "TuneDecision",
    "Autotuner",
    "machine_for_group",
    "get_tuner",
    "set_tuner",
    "reset_tuner",
    "autotune_schedule",
]
