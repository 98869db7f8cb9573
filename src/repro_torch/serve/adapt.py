"""Online-adaptation serving tier: continuously re-tuned schedule
selection under drifting traffic.

Port of ``repro.serve.adapt``, formula for formula, on the port's tuner
(:mod:`repro_torch.autotune`), learned gate and machine fit
(:mod:`repro_torch.learn`) and drift sentinel
(:mod:`repro_torch.obs.sentinel`).  Its differences from the reference:

* the default machine is :data:`~repro_torch.core.machine.H100_SXM`
  (the reference's is ``TPU_V5E``), as for the port's tuner, and the
  default analytic engine stays ``"numpy"``;
* ``device=`` names where the background machine re-fit
  (:func:`~repro_torch.learn.fit.fit_machine`, the ``"torch"`` grid
  engine) runs: ``None`` means the card, and a host without CUDA raises
  at construction unless the caller passes ``device="cpu"``.  The
  reference's fit runs wherever JAX does.

The pick path, the exploration policy, the re-fit cycle, the metric
names and the audit records are the reference's.

The paper pitches its FiCCO heuristics as signals "frameworks and
runtimes can harness"; :mod:`repro_torch.autotune` made that a tiered
runtime tuner, and :mod:`repro_torch.obs` gave it live signals — per-tier
pick counters, pick-latency histograms, gate-vs-argmin agreement, a
replayable audit log.  This module closes the loop for a long-lived
serving process whose traffic *drifts*:

* :class:`DecisionCache` — a bounded in-memory decision store keyed by
  :class:`~repro_torch.autotune.tuner.TuneKey` strings, LRU eviction +
  TTL.  The persistent :class:`~repro_torch.autotune.cache.AutotuneCache`
  is only a **warm-start** (preloaded at construction) and
  **write-behind** layer (``persist="defer"`` puts, flushed by the re-fit
  thread and atexit) — the hot path never touches disk.
* :class:`AdaptiveTier` — the pick path: memory hit -> analytic re-rank
  with the *currently deployed* gate/model -> (budgeted) measured tier.
  TTL expiry is what makes selection adaptive: a stale decision is
  re-ranked rather than served forever, so machine-model re-fits and
  gate swaps actually reach future picks.
* :class:`Refitter` — a background daemon thread that periodically (a)
  retrains the :class:`~repro_torch.learn.gate.LearnedGate` from a
  bounded buffer of *live* request scenarios and atomically swaps it into
  the tuner, (b) re-runs :func:`~repro_torch.learn.fit.fit_machine` over
  live ``Autotuner.measure`` records to tighten the analytic error bar,
  and (c) flushes the write-behind layer.  Swaps are single attribute
  stores — request threads see the old or the new artifact, never a
  torn one.
* :class:`ExplorationPolicy` — the measured-tier policy: ``measure()``
  fires only when the analytic shortlist's top-2 gap is inside the
  fitted machine model's log-time error bar (the model genuinely cannot
  separate the candidates) AND a token-bucket budget allows it — so
  exploration is bounded per wall-clock second no matter how hard
  traffic drifts.

Synthetic drifting traffic comes from
:func:`repro_torch.sweep.synth.drifting_request_stream`.  Metric
namespace (beside the tuner's ``tuner/pick.*``)::

  serve/adapt.decisions        total tier picks
  serve/adapt.pick.<tier>      memory | warm | analytic | measured | heuristic
  serve/adapt.pick_seconds     per-pick wall-time histogram
  serve/adapt.expired          TTL re-ranks (staleness-driven adaptation)
  serve/adapt.evicted          LRU evictions (bounded-memory proof)
  serve/adapt.measures         exploration-budget measured sessions
  serve/adapt.refits,.gate_swaps  background re-fit activity
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.autotune.tuner import Autotuner, TuneDecision, TuneKey
from repro_torch.core.heuristics import select_schedule
from repro_torch.core.machine import H100_SXM, MachineSpec, machine_for_group
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import GemmShape, StepProfile
from repro_torch.device import resolve_device
from repro_torch.obs import audit as _audit
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import signature as _signature
from repro_torch.obs import trace as _trace
from repro_torch.obs.sentinel import Sentinel, SentinelConfig


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Knobs of the online-adaptation tier (README "Online adaptation")."""

    cache_size: int = 4096        # in-memory decision bound (LRU beyond)
    ttl_s: float = 300.0          # decision freshness; expiry -> re-rank
    refit_interval_s: float = 2.0  # background re-fit cadence
    refit_min_picks: int = 64     # buffered scenarios before a gate retrain
    buffer_size: int = 2048       # live-scenario buffer bound (newest win)
    explore_rate: float = 1.0     # measured-tier token-bucket refill /s
    explore_burst: float = 8.0    # token-bucket capacity
    error_bar_z: float = 2.0      # top-2 gap within z*sigma -> explore
    default_sigma: float = 0.10   # log-time error bar before any fit
    fit_min_records: int = 6      # measured records before a machine re-fit
    fit_params: tuple[str, ...] = ("link_bw", "s_half")
    fit_steps: int = 120          # Adam steps per background re-fit
    gate_max_leaves: int = 8
    # Drift sentinel (repro_torch.obs.sentinel): monitors measured-tier
    # residuals + gate agreement; an alarm kicks the Refitter awake so
    # a refit runs at drift time, not at the next wall-clock interval.
    sentinel: bool = True
    sentinel_k: float = 0.5       # CUSUM reference (sigma units)
    sentinel_h: float = 8.0       # CUSUM decision threshold
    sentinel_min_samples: int = 8  # residuals before alarms arm
    sentinel_agreement_floor: float = 0.5
    # Deploy machine re-fits: patch fitted scalar MachineSpec params
    # (e.g. link_bw) into the tier's machine so future analytic
    # rankings/predictions use the calibrated values — what makes a
    # drift-triggered refit actually shrink the residual.
    deploy_fit: bool = True

    def __post_init__(self):
        if self.cache_size < 1:
            raise ValueError(f"cache_size must be >= 1, got {self.cache_size}")
        if self.ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {self.ttl_s}")


class TokenBucket:
    """Thread-safe token bucket: ``rate`` tokens/s up to ``burst``.

    ``try_take`` never blocks — a denied token means "serve the analytic
    answer now, explore later", which is the only acceptable behavior on
    a request path.
    """

    def __init__(self, rate: float, burst: float, *, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._stamp) * self.rate
            )
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class DecisionCache:
    """Bounded in-memory TuneKey -> decision store (LRU + TTL).

    A hit refreshes recency (LRU), never freshness: an entry older than
    ``ttl_s`` is dropped on lookup and the miss forces a re-rank under
    whatever gate/model the re-fit thread has deployed since — that is
    the adaptation mechanism, not a cache implementation detail.
    """

    def __init__(self, size: int, ttl_s: float, *, clock=time.monotonic):
        self.size = int(size)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._data: "collections.OrderedDict[str, tuple[TuneDecision, float]]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self.expired = 0
        self.evicted = 0

    def get(self, key: str) -> Optional[TuneDecision]:
        with self._lock:
            item = self._data.get(key)
            if item is None:
                return None
            dec, expires = item
            if self._clock() >= expires:
                del self._data[key]
                self.expired += 1
                return None
            self._data.move_to_end(key)
            return dec

    def put(self, key: str, dec: TuneDecision) -> None:
        with self._lock:
            self._data[key] = (dec, self._clock() + self.ttl_s)
            self._data.move_to_end(key)
            while len(self._data) > self.size:
                self._data.popitem(last=False)
                self.evicted += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._data


class ExplorationPolicy:
    """Measured-tier policy: explore only when the model cannot decide
    AND the budget allows.

    The analytic ranking's top-2 candidates are worth measuring exactly
    when their modelled gap is inside the machine model's own error bar
    — ``|log(t2/t1)| <= z * sigma`` where ``sigma`` is the fitted
    model's RMS log-time error (:class:`~repro_torch.learn.fit.FitResult`
    loss), updated by every background re-fit.  Even then a token
    bucket caps measured sessions per wall-clock second, so a drift
    step cannot stampede the measured tier.
    """

    def __init__(self, config: AdaptConfig, *, clock=time.monotonic):
        self._z = float(config.error_bar_z)
        self._sigma = float(config.default_sigma)
        self._bucket = TokenBucket(
            config.explore_rate, config.explore_burst, clock=clock
        )
        self.ambiguous = 0   # picks whose top-2 gap was inside the bar
        self.granted = 0     # ... that the budget actually let explore
        self.denied = 0      # ... denied by the token bucket

    @property
    def sigma(self) -> float:
        return self._sigma

    def set_sigma(self, sigma: float) -> None:
        """Atomic swap of the error bar (the re-fit thread's hook)."""
        self._sigma = max(float(sigma), 1e-6)

    def should_measure(self, ranked: Sequence[tuple[Schedule, float]]) -> bool:
        if len(ranked) < 2:
            return False
        t1, t2 = float(ranked[0][1]), float(ranked[1][1])
        if t1 <= 0.0 or t2 <= 0.0:
            return False
        if abs(math.log(t2 / t1)) > self._z * self._sigma:
            return False  # the model separates them confidently
        self.ambiguous += 1
        if self._bucket.try_take():
            self.granted += 1
            return True
        self.denied += 1
        return False


class AdaptiveTier:
    """The continuously-adapting schedule-selection tier.

    ``tuner`` supplies the analytic ranking, the learned-gate slot the
    re-fit thread swaps, and the persistent cache used as warm-start +
    write-behind (it is constructed with ``persist="defer"`` when not
    given).  ``measure_fn(gemm, candidates, profile) -> {Schedule:
    seconds}`` is the measured-tier hook — wrap
    :meth:`~repro_torch.autotune.tuner.Autotuner.measure` in a real
    deployment, or a simulator in benchmarks; ``None`` disables the
    measured tier regardless of budget.

    ``clock`` injects time for TTL/budget tests (monotonic seconds).
    ``device`` is where the machine re-fit runs (``None``: the card).
    Use as a context manager to scope the background re-fit thread::

        with AdaptiveTier(machine=machine) as tier:
            for req in stream:
                tier.pick(req.gemm, profile=req.profile)
    """

    def __init__(
        self,
        tuner: Autotuner | None = None,
        *,
        machine: MachineSpec | None = None,
        group: int | None = None,
        config: AdaptConfig | None = None,
        measure_fn: Callable | None = None,
        clock=time.monotonic,
        backend: str = "numpy",
        device=None,
    ):
        self.config = config or AdaptConfig()
        self.device = resolve_device(device)
        self.machine = machine or H100_SXM
        self.group = group
        self.tuner = tuner if tuner is not None else Autotuner(
            backend=backend, persist="defer"
        )
        self.measure_fn = measure_fn
        self._clock = clock
        self.cache = DecisionCache(
            self.config.cache_size, self.config.ttl_s, clock=clock
        )
        self.policy = ExplorationPolicy(self.config, clock=clock)
        # Live-scenario buffer the gate retrain trains on: newest
        # ``buffer_size`` (gemm, frac-or-None) pairs, i.e. the traffic
        # *after* a drift step quickly dominates.
        self._buffer: collections.deque = collections.deque(
            maxlen=self.config.buffer_size
        )
        self._buffer_lock = threading.Lock()
        self._refitter: Refitter | None = None
        self.gate_version = 0
        self.last_agreement: float | None = None
        self.sentinel: Sentinel | None = (
            Sentinel(SentinelConfig(
                k=self.config.sentinel_k,
                h=self.config.sentinel_h,
                min_samples=self.config.sentinel_min_samples,
                sigma0=self.config.default_sigma,
                agreement_floor=self.config.sentinel_agreement_floor,
            ))
            if self.config.sentinel
            else None
        )
        self.fit_deployed: list[str] = []
        self._warm_start()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "AdaptiveTier":
        """Start the background re-fit thread (idempotent).

        With a sentinel configured, its alarm hook kicks the re-fit
        thread awake immediately — drift triggers a refit at alarm
        time, not at the next wall-clock interval.
        """
        if self._refitter is None or not self._refitter.is_alive():
            self._refitter = Refitter(self)
            self._refitter.start()
        if self.sentinel is not None:
            self.sentinel.on_alarm = self._refitter.kick
        return self

    def stop(self) -> None:
        """Stop the re-fit thread and flush the write-behind layer."""
        if self.sentinel is not None:
            self.sentinel.on_alarm = None
        if self._refitter is not None:
            self._refitter.stop()
            self._refitter = None
        self.tuner.cache.flush()

    def __enter__(self) -> "AdaptiveTier":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- warm start ------------------------------------------------------

    def _warm_start(self) -> None:
        """Pre-seed the memory tier from the persistent store.

        The persistent cache is the cross-process memory; decisions it
        holds enter the LRU with a normal TTL, so they serve instantly
        on startup and still age out into re-ranks like any other
        entry.
        """
        reg = _metrics.get_metrics()
        n = 0
        for key, entry in self.tuner.cache.decision_entries().items():
            try:
                sched = Schedule(entry["schedule"])
            except (KeyError, ValueError):
                continue
            self.cache.put(
                key,
                TuneDecision(
                    sched,
                    "cache",
                    entry.get("model_total_s"),
                    entry.get("measured_total_s"),
                    key=key,
                ),
            )
            n += 1
            if n >= self.config.cache_size:
                break
        if n:
            reg.counter("serve/adapt.warm_start").inc(n)

    # -- the pick path ---------------------------------------------------

    def pick(
        self,
        gemm: GemmShape,
        machine: MachineSpec | None = None,
        *,
        group: int | None = None,
        profile: StepProfile | None = None,
    ) -> TuneDecision:
        """Tiered adaptive pick.  Never raises (heuristic fallback)."""
        machine = machine or self.machine
        group = group if group is not None else self.group
        tkey = TuneKey.for_gemm(gemm, machine, group, profile=profile)
        key = str(tkey)
        t0 = time.perf_counter()
        reg = _metrics.get_metrics()
        with _trace.span("serve/adapt.pick", "serve", key=key) as sp:
            dec = self.cache.get(key)
            if dec is not None:
                tier = "memory"
            else:
                try:
                    dec, tier = self._rank_and_decide(
                        gemm, machine, key, group, profile
                    )
                except Exception:
                    # Never-raise contract (same as the tuner's): any
                    # engine/model failure degrades to the static
                    # heuristic, un-cached so a healthy pick re-ranks.
                    hdec = select_schedule(
                        gemm,
                        machine_for_group(machine, group) if group else machine,
                        profile=profile,
                    )
                    dec, tier = (
                        TuneDecision(hdec.schedule, "heuristic", key=key),
                        "heuristic",
                    )
            sp.set(tier=tier, schedule=dec.schedule.value)
        self._observe_scenario(gemm, profile)
        seconds = time.perf_counter() - t0
        try:
            reg.counter("serve/adapt.decisions").inc()
            reg.counter(f"serve/adapt.pick.{tier}").inc()
            reg.histogram("serve/adapt.pick_seconds").observe(seconds)
            stream = _signature.get_signatures()
            if stream is not None:
                stream.observe_decision(
                    gemm, machine, dec.schedule,
                    group=group, profile=profile, source=tier,
                    model_total_s=dec.model_total_s,
                    measured_total_s=dec.measured_total_s,
                )
        except Exception:  # pragma: no cover - observability best-effort
            pass
        return dec

    def _rank_and_decide(
        self, gemm, machine, key: str, group, profile
    ) -> tuple[TuneDecision, str]:
        ranked = self.tuner.executable_ranking(
            gemm, machine, group=group, profile=profile
        )
        if (
            self.measure_fn is not None
            and self.policy.should_measure(ranked)
        ):
            dec = self._measure(gemm, ranked, key, profile)
            if dec is not None:
                self.cache.put(key, dec)
                return dec, "measured"
        sched, model_t = ranked[0]
        dec = TuneDecision(
            sched, "analytic", model_t, key=key,
            shortlist=tuple((s.value, float(t)) for s, t in ranked[:3]),
        )
        self.cache.put(key, dec)
        # Write-behind: the persistent layer learns the decision without
        # hot-path disk I/O (the re-fit thread / atexit flushes).
        self.tuner.cache.put(
            key,
            {
                "schedule": sched.value,
                "source": "analytic",
                "model_total_s": float(model_t),
                "measured_total_s": None,
            },
            persist="defer",
        )
        return dec, "analytic"

    def _measure(self, gemm, ranked, key: str, profile):
        """Budgeted measured tier: time the top-2, record + audit."""
        reg = _metrics.get_metrics()
        candidates = [s for s, _ in ranked[:2]]
        try:
            with _trace.span(
                "serve/adapt.measure", "serve", key=key,
                candidates=[s.value for s in candidates],
            ):
                timings = self.measure_fn(gemm, candidates, profile)
        except Exception:
            return None
        if not timings:
            return None
        winner = min(timings, key=timings.get)
        best = float(timings[winner])
        model_t = dict(ranked).get(winner)
        # Every measured session is a predicted/measured pair — the
        # drift sentinel's residual channel.
        if self.sentinel is not None and model_t:
            self.sentinel.observe_residual(float(model_t), best, key=key)
        self.tuner.cache.put(
            key,
            {
                "schedule": winner.value,
                "source": "measured",
                "model_total_s": float(model_t) if model_t else None,
                "measured_total_s": best,
            },
            persist="defer",
        )
        dec = TuneDecision(
            winner, "measured",
            model_total_s=float(model_t) if model_t else None,
            measured_total_s=best, key=key,
            shortlist=tuple(
                (s.value, float(t))
                for s, t in sorted(timings.items(), key=lambda kv: kv[1])
            ),
        )
        try:
            reg.counter("serve/adapt.measures").inc()
            log = _audit.get_audit()
            if log is not None:
                log.record({
                    "kind": "adapt_measure",
                    "key": key,
                    "schedule": winner.value,
                    "source": "measured",
                    "measured_total_s": best,
                    "shortlist": [[s.value, float(t)]
                                  for s, t in timings.items()],
                })
        except Exception:  # pragma: no cover - observability best-effort
            pass
        return dec

    # -- DecodeEngine wiring ---------------------------------------------

    def pick_for_requests(self, requests, cfg) -> TuneDecision:
        """Schedule pick for one decode batch's request-load digest.

        The batch's per-request work shares (prompt + generation
        tokens) are the serving-side analog of an expert-load profile:
        quantized to 64ths so identical load *shapes* share a cache key
        even when absolute lengths differ slightly.  The GEMM is the
        batch's FFN workload (total token rows x d_model x d_ff).
        """
        work = [
            max(len(r.prompt) + r.max_new_tokens, 1) for r in requests
        ] or [1]
        total = sum(work)
        profile = None
        if len(work) > 1:
            counts = StepProfile.from_weights(work, name="reqload").quantize(64)
            profile = StepProfile(
                tuple(c / 64 for c in counts), name="reqload"
            )
        gemm = GemmShape(total, cfg.d_ff, cfg.d_model, 2)
        return self.pick(gemm, profile=profile)

    # -- re-fit ----------------------------------------------------------

    def _observe_scenario(self, gemm, profile) -> None:
        frac = None if profile is None else tuple(profile.fractions)
        with self._buffer_lock:
            self._buffer.append(
                (gemm.m, gemm.n, gemm.k, gemm.dtype_bytes, frac)
            )

    def _snapshot_buffer(self):
        with self._buffer_lock:
            return list(self._buffer)

    def refit_now(self) -> dict:
        """One re-fit cycle, inline (what the background thread runs).

        Returns a report dict: ``gate_agreement`` (post-swap agreement
        on the live-traffic grid) and/or ``fit_sigma`` when the
        respective stage ran, plus ``flushed``.  Never raises.
        """
        reg = _metrics.get_metrics()
        drift = (
            self.sentinel is not None and self.sentinel.should_refit()
        )
        out: dict = {"trigger": "drift" if drift else "interval"}
        try:
            out.update(self._refit_gate())
        except Exception:
            out["gate_error"] = True
        try:
            out.update(self._refit_machine())
        except Exception:
            out["fit_error"] = True
        try:
            self.tuner.cache.flush()
            out["flushed"] = True
        except Exception:
            out["flushed"] = False
        try:
            reg.counter("serve/adapt.refits").inc()
        except Exception:  # pragma: no cover
            pass
        # Close the sentinel loop: a drift-triggered cycle (or one that
        # actually re-fit the machine model) resets the CUSUM and arms
        # post-refit recovery tracking.  Interval cycles that did
        # nothing model-relevant (the common idle case) don't spam
        # refit events.
        if self.sentinel is not None and (drift or "fit_sigma" in out):
            try:
                self.sentinel.record_refit(out, trigger=out["trigger"])
            except Exception:  # pragma: no cover
                pass
        return out

    def _grid_from_rows(self, rows):
        """Evaluate live-traffic rows ``(m, n, k, b, frac-or-None)``
        into a decision grid on the tier's effective machine."""
        from repro_torch.core.batch import RaggedBatch
        from repro_torch.core.engine import get_engine

        eff = (
            machine_for_group(self.machine, self.group)
            if self.group
            else self.machine
        )
        g = eff.group
        width = max(
            [len(f) for *_abcd, f in rows if f is not None] + [g]
        )
        m = np.asarray([r[0] for r in rows], dtype=np.int64)
        n = np.asarray([r[1] for r in rows], dtype=np.int64)
        k = np.asarray([r[2] for r in rows], dtype=np.int64)
        b = np.asarray([r[3] for r in rows], dtype=np.int64)
        frac = np.zeros((len(rows), width))
        uni = np.zeros(width)
        uni[:g] = 1.0 / g
        for i, (*_abcd, f) in enumerate(rows):
            if f is None:
                frac[i] = uni
            else:
                frac[i, : len(f)] = f
        batch = RaggedBatch(m=m, n=n, k=k, dtype_bytes=b, frac=frac)
        return get_engine(self.tuner.backend).evaluate(batch, [eff])

    def agreement_probe(self, pairs) -> Optional[float]:
        """Deployed gate's agreement on held-out traffic.

        ``pairs`` is a sequence of ``(GemmShape, StepProfile | None)``.
        Unlike the agreement a re-fit reports (the gate's *training*
        grid), this evaluates the currently deployed gate on traffic it
        was not trained on — the honest adaptation-lag signal after a
        drift step.  Returns ``None`` until a re-fit has deployed a
        gate.
        """
        from repro_torch.obs.metrics import observe_gate_agreement

        gate = self.tuner.gate
        if gate is None or not pairs:
            return None
        rows = [
            (
                g.m, g.n, g.k, g.dtype_bytes,
                None if p is None else tuple(p.fractions),
            )
            for g, p in pairs
        ]
        grid = self._grid_from_rows(rows)
        return observe_gate_agreement(grid, gate=gate)

    def _refit_gate(self) -> dict:
        from repro_torch.learn.gate import GATE_ARTIFACT_KIND, train_gate
        from repro_torch.obs.metrics import observe_gate_agreement

        rows = self._snapshot_buffer()
        if len(rows) < self.config.refit_min_picks:
            return {}
        with _trace.span(
            "serve/adapt.refit_gate", "serve", n_points=len(rows)
        ):
            grid = self._grid_from_rows(rows)
            gate = train_gate(
                grid, max_leaves=self.config.gate_max_leaves,
                meta={"trained_by": "serve.adapt", "n_live": len(rows)},
            )
            # Atomic swap: request threads see old or new, never torn.
            self.tuner.set_gate(gate)
            self.gate_version += 1
            agreement = observe_gate_agreement(grid, gate=gate)
        self.last_agreement = agreement
        if self.sentinel is not None:
            self.sentinel.observe_agreement(agreement)
        # Persist the deployed gate beside the decisions (write-behind).
        try:
            import json as _json

            self.tuner.cache.put_artifact(
                GATE_ARTIFACT_KIND,
                "adapt:" + self.machine.name.split("/", 1)[0],
                _json.loads(gate.to_json()),
                persist="defer",
            )
        except Exception:
            pass
        try:
            _metrics.get_metrics().counter("serve/adapt.gate_swaps").inc()
        except Exception:  # pragma: no cover
            pass
        return {"gate_agreement": agreement, "gate_points": len(rows)}

    def _refit_machine(self) -> dict:
        from repro_torch.learn.fit import (
            fit_machine,
            records_from_cache,
            save_fit,
        )

        records = records_from_cache(self.tuner.cache, self.machine.name)
        groups = {r.group for r in records}
        if len(records) < self.config.fit_min_records or len(groups) != 1:
            return {}
        with _trace.span(
            "serve/adapt.refit_machine", "serve", n_records=len(records)
        ):
            fit = fit_machine(
                self.machine, records,
                params=self.config.fit_params,
                steps=self.config.fit_steps,
                device=self.device,
            )
            # RMS log-time error IS the error bar the exploration
            # policy compares analytic gaps against — and the residual
            # scale the drift sentinel standardizes by.
            sigma = math.sqrt(max(fit.loss, 0.0))
            self.policy.set_sigma(sigma)
            if self.sentinel is not None:
                self.sentinel.set_sigma(sigma)
            save_fit(fit, cache=self.tuner.cache)
        out = {"fit_sigma": sigma, "fit_records": len(records)}
        deployed = self._deploy_fit(fit)
        if deployed:
            out["fit_deployed"] = ",".join(deployed)
        return out

    def _deploy_fit(self, fit) -> list[str]:
        """Patch fitted scalar MachineSpec params into the tier's
        machine (atomic attribute swap — request threads see the old or
        the new spec, never a torn one).

        Only fitted params that are real :class:`~repro_torch.core.machine.
        MachineSpec` fields deploy this way (``link_bw`` is; ``s_half``
        is a derived calibration array, consumed through the persisted
        :class:`~repro_torch.learn.fit.FitResult` instead).  The spec's name
        is preserved, so measured records keep accumulating under the
        same machine key.
        """
        if not self.config.deploy_fit:
            return []
        field_names = {
            f.name for f in dataclasses.fields(type(self.machine))
        }
        patch = {}
        for k, v in fit.fitted.items():
            if k not in field_names:
                continue
            try:
                patch[k] = float(v)  # accepts numpy/torch scalars too
            except (TypeError, ValueError):
                continue
        if not patch:
            return []
        self.machine = dataclasses.replace(self.machine, **patch)
        self.fit_deployed = sorted(patch)
        try:
            _metrics.get_metrics().counter("serve/adapt.fit_deploys").inc()
        except Exception:  # pragma: no cover
            pass
        return self.fit_deployed

    # -- reporting -------------------------------------------------------

    def stats(self) -> dict:
        """One self-describing view of the tier's state (launchers)."""
        return {
            "cache_len": len(self.cache),
            "cache_expired": self.cache.expired,
            "cache_evicted": self.cache.evicted,
            "gate_version": self.gate_version,
            "last_agreement": self.last_agreement,
            "sigma": self.policy.sigma,
            "explore_ambiguous": self.policy.ambiguous,
            "explore_granted": self.policy.granted,
            "explore_denied": self.policy.denied,
            "persistent_dirty": self.tuner.cache.dirty,
            "fit_deployed": list(self.fit_deployed),
            "sentinel": (
                None if self.sentinel is None else self.sentinel.state()
            ),
        }


class Refitter(threading.Thread):
    """Daemon thread running :meth:`AdaptiveTier.refit_now` on a cadence
    — or immediately when :meth:`kick`\\ ed (the drift sentinel's alarm
    hook), so a detected drift is acted on at alarm time instead of
    waiting out the wall-clock interval.

    ``stop()`` wakes the wait and joins; the final cycle's flush is the
    tier's (``AdaptiveTier.stop`` flushes after joining, so nothing
    recorded between the last cycle and the stop is lost).
    """

    def __init__(self, tier: AdaptiveTier):
        super().__init__(name="serve-adapt-refit", daemon=True)
        self.tier = tier
        # NB: not named ``_stop`` — Thread.join's internals call a
        # private ``_stop()`` method and an Event would shadow it.
        self._halt = threading.Event()
        self._kick = threading.Event()
        self.kicks = 0

    def kick(self) -> None:
        """Wake the thread for an immediate re-fit cycle (thread-safe;
        coalesces — multiple kicks before the wake run one cycle)."""
        self.kicks += 1
        self._kick.set()

    def run(self) -> None:
        while True:
            self._kick.wait(self.tier.config.refit_interval_s)
            self._kick.clear()
            if self._halt.is_set():
                return
            self.tier.refit_now()

    def stop(self, timeout: float = 10.0) -> None:
        self._halt.set()
        self._kick.set()  # wake the wait so the halt is seen now
        self.join(timeout=timeout)


def simulated_measure_fn(
    machine: MachineSpec,
    *,
    noise: float = 0.03,
    seed: int = 0,
    backend: str = "numpy",
):
    """A measured-tier hook backed by the analytic model + log-normal
    noise — the benchmark/test stand-in for timing real collectives
    (wrap :meth:`~repro_torch.autotune.tuner.Autotuner.measure` in a real
    deployment).
    """
    from repro_torch.core.engine import get_engine
    from repro_torch.core.engine import shortlist as engine_shortlist

    eng = get_engine(backend)
    rng = np.random.default_rng(seed)

    def measure(gemm, candidates, profile):
        ranked = engine_shortlist(
            gemm, machine, top=None, engine=eng, profile=profile
        )
        times = {s: t for s, t in ranked}
        out = {}
        for sched in candidates:
            if sched in times:
                out[sched] = float(
                    times[sched] * np.exp(rng.normal(0.0, noise))
                )
        return out

    return measure


__all__ = [
    "AdaptConfig",
    "TokenBucket",
    "DecisionCache",
    "ExplorationPolicy",
    "AdaptiveTier",
    "Refitter",
    "simulated_measure_fn",
]
