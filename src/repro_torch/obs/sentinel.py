"""Drift sentinel: EWMA/CUSUM monitoring of predicted-vs-measured
residuals and gate agreement, with typed refit-trigger events.

Port of ``repro.obs.sentinel``, formula for formula: the same state
machine, event fields and schema, so the reference's
``validate_sentinel`` accepts this module's ``export_jsonl`` and the
other way round.  Events go into the port's audit log, metrics registry
and tracer (:mod:`repro_torch.obs`).

The adaptive serving tier (:mod:`repro_torch.serve.adapt`) re-fits on a
wall-clock cadence; that bounds *staleness*, not *wrongness* — a link
that silently degrades mid-stream leaves the analytic model confidently
ranking schedules with a stale bandwidth until the next interval fires,
and gate-only refits never notice at all.  This module watches the two
live correctness signals the stack already produces:

* **residual channel** — every measured-tier session yields a
  predicted/measured pair; the sentinel tracks ``r = log(measured /
  predicted)`` with an EWMA (location) and a two-sided standardized
  CUSUM (drift detection): ``S+ = max(0, S+ + z - k)``, ``S- = max(0,
  S- - z - k)`` with ``z = r / sigma``.  Crossing ``h`` raises a drift
  alarm.
* **agreement channel** — the gate-vs-analytic-argmin agreement each
  re-fit reports, EWMA'd; falling below a floor raises an alarm.

An alarm latches :meth:`Sentinel.should_refit` (the
:class:`~repro_torch.serve.adapt.Refitter` polls it and can be kicked awake
via :attr:`Sentinel.on_alarm`), and every state transition — alarm,
refit, post-refit recovery — is emitted as a typed, schema-validated
event (:func:`validate_sentinel`), appended to the decision audit log
(kinds ``sentinel_alarm`` / ``sentinel_refit`` / ``sentinel_recovery``)
and counted in the metrics registry, so the full drift story reads
beside the decisions it affected.

Stdlib-only; pure state machine (no threads of its own) — safe to feed
from request threads and the re-fit thread concurrently.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """Knobs of the drift monitor.

    ``k``/``h`` are the standardized CUSUM's reference and decision
    values: with in-control residuals ~N(0, sigma), ``k=0.5`` tunes the
    chart to detect ~1-sigma mean shifts fastest and ``h=8`` puts the
    in-control false-alarm run length in the thousands of samples; a
    sustained 2-sigma shift alarms after ~h / (2 - k) ~ 5 samples.
    """

    alpha: float = 0.2            # residual-EWMA smoothing
    k: float = 0.5                # CUSUM reference (in sigma units)
    h: float = 8.0                # CUSUM decision threshold
    min_samples: int = 8          # residuals before alarms are armed
    sigma0: float = 0.10          # log-time scale before any fit
    agreement_floor: float = 0.5  # EWMA agreement below this -> alarm
    agreement_alpha: float = 0.2
    agreement_min: int = 3        # agreement reports before that arms
    max_events: int = 256         # bounded in-memory event history

    def __post_init__(self):
        if self.h <= 0:
            raise ValueError(f"h must be > 0, got {self.h}")
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")


class Sentinel:
    """The drift state machine.  All mutation under one lock; the
    hot-path cost is a handful of float updates."""

    def __init__(self, config: SentinelConfig | None = None, *,
                 clock=time.time):
        self.config = config or SentinelConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._sigma = float(self.config.sigma0)
        # Residual channel.
        self._n = 0
        self._ewma: float | None = None
        self._cusum_pos = 0.0
        self._cusum_neg = 0.0
        # Agreement channel.
        self._agree_n = 0
        self._agree_ewma: float | None = None
        # Alarm latch + post-refit recovery tracking.
        self._alarmed: str | None = None   # channel name, or None
        self._recovering = False
        self._pre_refit_ewma: float | None = None
        self._post_n = 0
        self._post_sum = 0.0
        self._post_sumsq = 0.0
        self.events: list[dict] = []
        self.alarms = 0
        self.refits = 0
        self.on_alarm = None  # callable hook (e.g. Refitter.kick)

    # -- feeding ---------------------------------------------------------

    def set_sigma(self, sigma: float) -> None:
        """Atomic swap of the residual scale (the re-fit thread's hook,
        same contract as ``ExplorationPolicy.set_sigma``)."""
        self._sigma = max(float(sigma), 1e-6)

    def observe_residual(
        self, predicted_s: float, measured_s: float, *, key: str | None = None
    ) -> bool:
        """Feed one predicted/measured pair; True if this sample raised
        a drift alarm.  Never raises on degenerate inputs (skipped)."""
        if (
            not isinstance(predicted_s, (int, float))
            or not isinstance(measured_s, (int, float))
            or predicted_s <= 0.0
            or measured_s <= 0.0
        ):
            return False
        r = math.log(measured_s / predicted_s)
        cfg = self.config
        fires: list[dict] = []
        with self._lock:
            self._n += 1
            self._ewma = (
                r if self._ewma is None
                else (1.0 - cfg.alpha) * self._ewma + cfg.alpha * r
            )
            z = r / self._sigma
            self._cusum_pos = max(0.0, self._cusum_pos + z - cfg.k)
            self._cusum_neg = max(0.0, self._cusum_neg - z - cfg.k)
            if self._recovering:
                self._post_n += 1
                self._post_sum += r
                self._post_sumsq += r * r
                if self._post_n >= cfg.min_samples:
                    fires.append(self._recovery_event_locked())
            if (
                self._alarmed is None
                and self._n >= cfg.min_samples
                and max(self._cusum_pos, self._cusum_neg) > cfg.h
            ):
                self._alarmed = "residual"
                self.alarms += 1
                fires.append(self._event_locked(
                    "sentinel_alarm",
                    channel="residual",
                    key=key,
                    residual=r,
                ))
        for ev in fires:
            self._emit(ev)
        return any(ev["kind"] == "sentinel_alarm" for ev in fires)

    def observe_agreement(self, rate: float) -> bool:
        """Feed one gate-vs-argmin agreement rate; True on alarm."""
        if not isinstance(rate, (int, float)) or not 0.0 <= rate <= 1.0:
            return False
        cfg = self.config
        fire = None
        with self._lock:
            self._agree_n += 1
            self._agree_ewma = (
                rate if self._agree_ewma is None
                else (1.0 - cfg.agreement_alpha) * self._agree_ewma
                + cfg.agreement_alpha * rate
            )
            if (
                self._alarmed is None
                and self._agree_n >= cfg.agreement_min
                and self._agree_ewma < cfg.agreement_floor
            ):
                self._alarmed = "agreement"
                self.alarms += 1
                fire = self._event_locked(
                    "sentinel_alarm", channel="agreement", rate=rate
                )
        if fire is not None:
            self._emit(fire)
            return True
        return False

    # -- the refit contract ---------------------------------------------

    def should_refit(self) -> bool:
        """Latched drift verdict (cleared by :meth:`record_refit`)."""
        return self._alarmed is not None

    def record_refit(self, report: dict | None = None, *,
                     trigger: str = "interval") -> dict:
        """Note that a refit ran: emits ``sentinel_refit``, resets the
        CUSUM, clears the alarm latch, and arms recovery tracking (the
        next ``min_samples`` residuals are summarized against the
        pre-refit EWMA in a ``sentinel_recovery`` event)."""
        with self._lock:
            self.refits += 1
            ev = self._event_locked(
                "sentinel_refit",
                trigger=trigger,
                channel=self._alarmed,
                report={
                    k: v for k, v in (report or {}).items()
                    if isinstance(v, (int, float, str, bool)) or v is None
                },
            )
            self._pre_refit_ewma = self._ewma
            self._alarmed = None
            self._cusum_pos = 0.0
            self._cusum_neg = 0.0
            self._ewma = None
            self._recovering = True
            self._post_n = 0
            self._post_sum = 0.0
            self._post_sumsq = 0.0
        self._emit(ev)
        return ev

    def _recovery_event_locked(self) -> dict:
        n = self._post_n
        mean = self._post_sum / n
        var = max(self._post_sumsq / n - mean * mean, 0.0)
        self._recovering = False
        return self._event_locked(
            "sentinel_recovery",
            pre_refit_ewma=self._pre_refit_ewma,
            post_refit_ewma=self._ewma,
            post_mean=mean,
            post_rms=math.sqrt(mean * mean + var),
            samples=n,
        )

    # -- events ----------------------------------------------------------

    def _event_locked(self, kind: str, **fields) -> dict:
        ev = {
            "kind": kind,
            "ts": self._clock(),
            "n": self._n,
            "ewma": self._ewma,
            "cusum_pos": self._cusum_pos,
            "cusum_neg": self._cusum_neg,
            "sigma": self._sigma,
            "agreement_ewma": self._agree_ewma,
            **fields,
        }
        self.events.append(ev)
        if len(self.events) > self.config.max_events:
            del self.events[: len(self.events) - self.config.max_events]
        return ev

    def _emit(self, ev: dict) -> None:
        """Audit + metrics + trace + alarm hook; never raises."""
        from repro_torch.obs import audit as _audit
        from repro_torch.obs import metrics as _metrics
        from repro_torch.obs import trace as _trace

        try:
            _metrics.get_metrics().counter(
                "sentinel/" + ev["kind"].split("_", 1)[1] + "s"
            ).inc()
            _trace.instant(ev["kind"], "sentinel", **{
                k: v for k, v in ev.items()
                if isinstance(v, (int, float, str, bool))
            })
            log = _audit.get_audit()
            if log is not None:
                log.record(dict(ev))
        except Exception:  # pragma: no cover - observability best-effort
            pass
        if ev["kind"] == "sentinel_alarm" and self.on_alarm is not None:
            try:
                self.on_alarm()
            except Exception:  # pragma: no cover
                pass

    # -- reporting -------------------------------------------------------

    def state(self) -> dict:
        with self._lock:
            return {
                "n": self._n,
                "ewma": self._ewma,
                "cusum_pos": self._cusum_pos,
                "cusum_neg": self._cusum_neg,
                "sigma": self._sigma,
                "agreement_ewma": self._agree_ewma,
                "alarmed": self._alarmed,
                "recovering": self._recovering,
                "alarms": self.alarms,
                "refits": self.refits,
                "events": len(self.events),
            }

    def export_jsonl(self, path: str) -> int:
        """Append every retained event as one JSONL line each; returns
        the number written."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with self._lock:
            events = list(self.events)
        with open(path, "a") as f:
            for ev in events:
                f.write(json.dumps(ev) + "\n")
        return len(events)


# ---------------------------------------------------------------------------
# Event schema (the reference's scripts/trace.py validate --kind
# sentinel).
# ---------------------------------------------------------------------------

EVENT_KINDS = ("sentinel_alarm", "sentinel_refit", "sentinel_recovery")
_NUMERIC = ("ts", "n", "cusum_pos", "cusum_neg", "sigma")


def validate_sentinel(records) -> list[str]:
    """Structural errors in sentinel event records ([] == valid)."""
    errors: list[str] = []
    for i, ev in enumerate(records):
        if not isinstance(ev, dict):
            errors.append(f"event[{i}]: not an object")
            continue
        kind = ev.get("kind")
        if kind not in EVENT_KINDS:
            errors.append(f"event[{i}]: unknown kind {kind!r}")
            continue
        for field in _NUMERIC:
            if not isinstance(ev.get(field), (int, float)):
                errors.append(f"event[{i}] ({kind}): no numeric {field!r}")
        if kind == "sentinel_alarm" and ev.get("channel") not in (
            "residual", "agreement"
        ):
            errors.append(f"event[{i}]: bad channel {ev.get('channel')!r}")
        if kind == "sentinel_refit" and not isinstance(
            ev.get("trigger"), str
        ):
            errors.append(f"event[{i}]: refit needs a 'trigger' string")
        if kind == "sentinel_recovery" and not isinstance(
            ev.get("samples"), int
        ):
            errors.append(f"event[{i}]: recovery needs integer 'samples'")
        if len(errors) > 50:
            errors.append("... (truncated)")
            break
    return errors


__all__ = [
    "SentinelConfig",
    "Sentinel",
    "EVENT_KINDS",
    "validate_sentinel",
]
