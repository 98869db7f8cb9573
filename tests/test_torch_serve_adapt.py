"""The port's online-adaptation serving tier (``repro_torch.serve.adapt``)
and drift sentinel (``repro_torch.obs.sentinel``).

* The sentinel against ``repro.obs.sentinel`` in process, bit for bit: the
  same seeded residual and agreement streams, ``state()`` after every
  step, the events without timestamps, and each side's
  ``validate_sentinel`` on the other's ``export_jsonl``.
* The tier's own behaviour, the cases of ``tests/test_serve_adapt.py``
  that need no import of ``repro.serve.adapt`` (it reaches
  ``repro.autotune``, which does not import under jax 0.9.0): the decision
  cache, the token bucket, the exploration policy, tier routing, warm
  start, write-behind, the measured budget and its audit, the request-load
  digest, the gate re-fit, stats, threads, and the drift loop (alarm ->
  drift re-fit -> deployed ``link_bw`` -> recovery).  Clocks are injected;
  the machine re-fit runs on the CPU.
* Parity with the reference's ``AdaptiveTier`` through the shared JAX
  subprocess (``tests/torch_jax_reference.py``, entry ``adapt``): the same
  scripted run on both packages.
* The wiring: ``DecodeEngine(adapt=...)`` and ``launch/serve.py --adapt
  --signatures``.
"""

import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch_jax_reference as ref_driver

from repro.obs import sentinel as jsentinel
from repro_torch.autotune import AutotuneCache, Autotuner, TuneKey, reset_tuner
from repro_torch.configs import get_config
from repro_torch.core.machine import H100_SXM, TPU_V5E
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import GemmShape
from repro_torch.learn import clear_machine_gates, set_default_gate
from repro_torch.models.model import build_model
from repro_torch.obs import audit, metrics, sentinel, signature
from repro_torch.obs import trace as _trace
from repro_torch.serve.adapt import (
    AdaptConfig,
    AdaptiveTier,
    DecisionCache,
    ExplorationPolicy,
    TokenBucket,
    simulated_measure_fn,
)
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.sweep.synth import drifting_request_stream

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

GEMM = GemmShape(16384, 16384, 32768, 2)


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """The port's process-wide tuner, audit log, signature stream,
    tracer, metrics and learned gates (``tests/conftest.py`` resets the
    reference's only)."""

    def reset():
        reset_tuner()
        audit.disable_audit()
        signature._STREAM = None
        _trace._TRACER = None
        metrics.reset_metrics()
        set_default_gate(None)
        clear_machine_gates()

    reset()
    yield
    reset()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    """The JAX subprocess runs while the port-only tests run."""
    ref_driver.start(tmp_path_factory)


FakeClock = ref_driver.FakeClock


def _tier(tmp_path, name="adapt.json", *, clock=None, config=None,
          measure_fn=None):
    tuner = Autotuner(
        cache=AutotuneCache(path=str(tmp_path / name)),
        backend="numpy",
        persist="defer",
    )
    kw = {} if clock is None else {"clock": clock}
    return AdaptiveTier(
        tuner, machine=TPU_V5E, config=config or AdaptConfig(),
        measure_fn=measure_fn, device="cpu", **kw,
    )


def _counter(name):
    return metrics.get_metrics().counter(name).value


# ---------------------------------------------------------------------------
# The sentinel, bit for bit against repro.obs.sentinel.
# ---------------------------------------------------------------------------

def _sentinel_stream(case: str, n: int = 80):
    """Seeded feed: ("residual", predicted, measured), ("agreement",
    rate) and ("refit",) steps.  "drift" shifts the log-residual by 0.5
    from step 30, and a refit runs once an alarm latches; "agreement"
    lets the gate agreement decay; "steady" stays in control, with
    degenerate pairs mixed in."""
    seed = {"steady": 0, "drift": 1, "agreement": 2}[case]
    rng = np.random.default_rng(seed)
    steps = []
    refitted = False
    for i in range(n):
        pred = float(np.exp(rng.normal(-7.0, 1.0)))
        shift = 0.5 if case == "drift" and i >= 30 and not refitted else 0.0
        meas = pred * float(np.exp(rng.normal(shift, 0.05)))
        if case == "steady" and i % 17 == 3:
            steps.append(("residual", 0.0, meas))   # skipped
        steps.append(("residual", pred, meas))
        if i % 5 == 4:
            top = 0.9 if case != "agreement" else max(0.9 - 0.05 * i, 0.0)
            steps.append(("agreement", float(rng.uniform(0.0, top))
                          if case == "agreement" else top))
        if case == "drift" and i == 45:
            steps.append(("refit",))
            refitted = True
    return steps


def _drive_sentinel(mod, steps, clock):
    s = mod.Sentinel(mod.SentinelConfig(min_samples=6), clock=clock)
    states, fired = [], []
    for step in steps:
        clock.advance(0.5)
        if step[0] == "residual":
            fired.append(s.observe_residual(step[1], step[2], key="k"))
        elif step[0] == "agreement":
            fired.append(s.observe_agreement(step[1]))
        else:
            fired.append(s.record_refit({"fit_sigma": 0.05, "x": [1]},
                                        trigger="drift"))
        states.append(s.state())
    return s, states, fired


@pytest.mark.parametrize("case", ["steady", "drift", "agreement"])
def test_sentinel_matches_reference_bit_for_bit(case, tmp_path):
    steps = _sentinel_stream(case)
    port, p_states, p_fired = _drive_sentinel(sentinel, steps, FakeClock())
    ref, r_states, r_fired = _drive_sentinel(jsentinel, steps, FakeClock())
    assert p_states == r_states  # every float bit for bit
    assert p_fired == r_fired
    strip = [[{k: v for k, v in e.items() if k != "ts"} for e in s.events]
             for s in (port, ref)]
    assert strip[0] == strip[1]
    if case == "steady":
        assert port.alarms == 0
    else:
        assert port.alarms >= 1
        assert {e["kind"] for e in port.events} >= {"sentinel_alarm"}
    if case == "drift":
        kinds = [e["kind"] for e in port.events]
        assert kinds[:3] == ["sentinel_alarm", "sentinel_refit",
                             "sentinel_recovery"]
    # Each side's schema accepts the other's export.
    for src, validate, name in ((port, jsentinel.validate_sentinel, "p"),
                                (ref, sentinel.validate_sentinel, "r")):
        path = str(tmp_path / f"{name}.jsonl")
        assert src.export_jsonl(path) == len(src.events)
        with open(path) as fh:
            recs = [json.loads(line) for line in fh]
        assert validate(recs) == []


def test_sentinel_events_reach_audit_and_metrics(tmp_path):
    log = tmp_path / "audit.jsonl"
    audit.enable_audit(str(log))
    _trace.enable()
    s = sentinel.Sentinel(sentinel.SentinelConfig(min_samples=2))
    kicks = []
    s.on_alarm = lambda: kicks.append(1)
    for _ in range(6):
        s.observe_residual(1.0, 3.0)  # log 3 / 0.1 sigma: far out
    assert s.should_refit() and kicks == [1]
    s.record_refit({"fit_sigma": 0.1})
    recs = audit.read_audit(str(log))
    assert [r["kind"] for r in recs] == ["sentinel_alarm", "sentinel_refit"]
    assert audit.validate_audit(recs) == []
    assert sentinel.validate_sentinel(recs) == []
    assert _counter("sentinel/alarms") == 1
    assert _counter("sentinel/refits") == 1
    names = [e["name"] for e in _trace.get_tracer().events]
    assert names == ["sentinel_alarm", "sentinel_refit"]
    bad = [{"kind": "sentinel_alarm", "channel": "x"}, {"kind": "nope"}, 3]
    assert len(sentinel.validate_sentinel(bad)) >= 3
    with pytest.raises(ValueError):
        sentinel.SentinelConfig(h=0.0)


# ---------------------------------------------------------------------------
# Decision cache, token bucket, exploration policy.
# ---------------------------------------------------------------------------

def test_decision_cache_ttl_lru_and_recency():
    clk = FakeClock()
    c = DecisionCache(3, ttl_s=10.0, clock=clk)
    for k in "abc":
        c.put(k, k.upper())
    assert c.get("a") == "A"  # refresh a's recency
    c.put("d", "D")           # evicts b, the least recent
    assert c.evicted == 1 and c.get("b") is None
    assert all(c.get(k) for k in "acd") and len(c) == 3
    clk.advance(6.0)
    assert c.get("a") == "A"  # a hit at t=6 does NOT reset the TTL
    clk.advance(4.0)
    assert c.get("a") is None and c.expired == 1
    assert "c" in c and len(c) == 2  # "c", "d" expire on lookup only


def test_token_bucket_burst_refill_and_cap():
    clk = FakeClock()
    b = TokenBucket(rate=1.0, burst=2.0, clock=clk)
    assert b.try_take() and b.try_take()
    assert not b.try_take()  # burst exhausted, clock frozen
    clk.advance(1.0)
    assert b.try_take() and not b.try_take()
    clk.advance(60.0)
    assert sum(b.try_take() for _ in range(10)) == 2  # capped at burst


def test_exploration_policy_grant_deny_and_sigma_swap():
    p = ExplorationPolicy(AdaptConfig(explore_rate=0.0, explore_burst=2.0),
                          clock=FakeClock())
    confident = [(Schedule.SERIAL, 1.0), (Schedule.UNIFORM_FUSED_1D, 1.5)]
    assert not p.should_measure(confident) and p.ambiguous == 0
    close = [(Schedule.SERIAL, 1.00), (Schedule.UNIFORM_FUSED_1D, 1.01)]
    grants = [p.should_measure(close) for _ in range(6)]
    assert grants == [True, True, False, False, False, False]
    assert (p.ambiguous, p.granted, p.denied) == (6, 2, 4)
    p.set_sigma(5.0)  # a terrible model: the confident gap turns ambiguous
    assert not p.should_measure(confident) and p.ambiguous == 7  # no tokens
    assert p.sigma == 5.0
    assert not p.should_measure([])
    assert not p.should_measure([(Schedule.SERIAL, 1.0)])
    assert not p.should_measure(
        [(Schedule.SERIAL, 0.0), (Schedule.UNIFORM_FUSED_1D, 0.0)])


# ---------------------------------------------------------------------------
# The tier.
# ---------------------------------------------------------------------------

def test_memory_tier_then_ttl_rerank(tmp_path):
    clk = FakeClock()
    tier = _tier(tmp_path, clock=clk, config=AdaptConfig(ttl_s=60.0))
    d1, d2 = tier.pick(GEMM), tier.pick(GEMM)
    assert d1.schedule == d2.schedule
    assert _counter("serve/adapt.pick.analytic") == 1
    assert _counter("serve/adapt.pick.memory") == 1
    clk.advance(61.0)
    tier.pick(GEMM)
    assert _counter("serve/adapt.pick.analytic") == 2
    assert tier.cache.expired == 1
    assert _counter("serve/adapt.decisions") == 3
    assert metrics.get_metrics().histogram(
        "serve/adapt.pick_seconds").count == 3


def test_default_machine_is_h100_and_device_is_explicit(monkeypatch):
    tier = AdaptiveTier(device="cpu")
    assert tier.machine is H100_SXM and tier.tuner.persist == "defer"
    assert tier.tuner.backend == "numpy" and tier.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AdaptiveTier()


def test_never_raises_falls_back_to_heuristic(tmp_path, monkeypatch):
    tier = _tier(tmp_path)

    def boom(*a, **kw):
        raise RuntimeError("engine down")

    monkeypatch.setattr(tier.tuner, "executable_ranking", boom)
    assert tier.pick(GEMM).source == "heuristic"
    assert _counter("serve/adapt.pick.heuristic") == 1
    # Un-cached: a healthy pick re-ranks instead of serving the
    # degraded answer from memory.
    monkeypatch.undo()
    assert tier.pick(GEMM).source == "analytic"


def test_warm_start_from_persistent_store(tmp_path):
    tier1 = _tier(tmp_path, "shared.json")
    gemms = [GEMM, GemmShape(8192, 8192, 16384, 2)]
    for g in gemms:
        tier1.pick(g)
    tier1.tuner.cache.flush()
    before = _counter("serve/adapt.pick.analytic")
    tier2 = _tier(tmp_path, "shared.json")
    assert _counter("serve/adapt.warm_start") == len(gemms)
    for g in gemms:
        assert tier2.pick(g).schedule == tier1.pick(g).schedule
    assert _counter("serve/adapt.pick.analytic") == before


def test_write_behind_defers_disk_io(tmp_path):
    tier = _tier(tmp_path, "defer.json")
    tier.pick(GEMM)
    path = tier.tuner.cache.path
    assert tier.tuner.cache.dirty
    assert not os.path.exists(path)  # the hot path never wrote
    tier.stop()                      # stop() flushes
    assert not tier.tuner.cache.dirty
    key = str(TuneKey.for_gemm(GEMM, TPU_V5E, None))
    assert key in AutotuneCache(path=path).decision_entries()


def test_measured_tier_budget_and_audit(tmp_path):
    log_path = tmp_path / "audit.jsonl"
    audit.enable_audit(str(log_path))
    tier = _tier(
        tmp_path, clock=FakeClock(),
        config=AdaptConfig(explore_rate=0.0, explore_burst=3.0),
        measure_fn=simulated_measure_fn(TPU_V5E, seed=0),
    )
    tier.policy.set_sigma(10.0)  # every top-2 gap is "ambiguous"
    gemms = [GemmShape(1024 * 8 * (i + 1), 8192, 8192, 2) for i in range(8)]
    decisions = [tier.pick(g) for g in gemms]
    # Frozen clock + rate 0: the burst is the whole budget.
    assert sum(d.source == "measured" for d in decisions) == 3
    assert (tier.policy.granted, tier.policy.denied) == (3, 5)
    assert _counter("serve/adapt.measures") == 3
    recs = audit.read_audit(str(log_path))
    assert sum(r["kind"] == "adapt_measure" for r in recs) == 3
    assert audit.validate_audit(recs) == []
    # A measured decision carries its timings, fastest first.
    dec = decisions[0]
    assert dec.measured_total_s == dec.shortlist[0][1]


def test_failing_measure_fn_serves_the_analytic_answer(tmp_path):
    def broken(gemm, candidates, profile):
        raise RuntimeError("card lost")

    tier = _tier(tmp_path, measure_fn=broken)
    tier.policy.set_sigma(10.0)
    assert tier.pick(GEMM).source == "analytic"
    assert _counter("serve/adapt.measures") == 0


def test_pick_for_requests_load_digest(tmp_path):
    tier = _tier(tmp_path)

    class Cfg:
        d_model, d_ff = 4096, 16384

    reqs = [Request(np.zeros(8, np.int32), max_new_tokens=24),
            Request(np.zeros(16, np.int32), max_new_tokens=48)]
    dec = tier.pick_for_requests(reqs, Cfg)
    assert dec.key.startswith(f"{TPU_V5E.name}/g") and "/m96/" in dec.key
    assert "/reqload-" in dec.key  # the 1:2 load digest
    even = tier.pick_for_requests(
        [Request(np.zeros(8, np.int32), max_new_tokens=24)] * 2, Cfg)
    assert even.key.endswith("/u2")  # an even load is the uniform cut
    before = _counter("serve/adapt.pick.memory")
    tier.pick_for_requests(
        [Request(np.zeros(16, np.int32), max_new_tokens=48),
         Request(np.zeros(32, np.int32), max_new_tokens=96)], Cfg)
    # 2x the tokens changes the GEMM M, so keys differ; a single request
    # always collapses to the uniform profile.
    one = tier.pick_for_requests(
        [Request(np.zeros(8, np.int32), max_new_tokens=24)], Cfg)
    assert "reqload" not in one.key
    assert _counter("serve/adapt.pick.memory") == before


def test_refit_deploys_gate_and_tracks_agreement(tmp_path):
    cfg = AdaptConfig(refit_min_picks=64, buffer_size=512,
                      fit_min_records=10 ** 9)
    tier = _tier(tmp_path, config=cfg)
    assert tier.refit_now().get("gate_agreement") is None  # too few
    reqs = list(drifting_request_stream(120, seed=0, drift_every=1000))
    for r in reqs:
        tier.pick(r.gemm, profile=r.profile)
    rep = tier.refit_now()
    assert tier.gate_version == 1 and tier.tuner.gate is not None
    assert 0.0 < rep["gate_agreement"] <= 1.0
    assert tier.last_agreement == rep["gate_agreement"] and rep["flushed"]
    # The gate persists beside the decisions, keyed by the machine family.
    art = tier.tuner.cache.get_artifact("gate", "adapt:" + TPU_V5E.name)
    assert art == json.loads(tier.tuner.gate.to_json())
    ag = tier.agreement_probe([(r.gemm, r.profile) for r in reqs[:64]])
    assert 0.0 < ag <= 1.0
    for r in drifting_request_stream(80, seed=5, drift_every=40):
        tier.pick(r.gemm, profile=r.profile)
    tier.refit_now()
    assert tier.gate_version == 2
    assert _counter("serve/adapt.gate_swaps") == 2


def test_stats_surface(tmp_path):
    tier = _tier(tmp_path)
    tier.pick(GEMM)
    s = tier.stats()
    assert s["cache_len"] == 1 and s["persistent_dirty"] is True
    assert set(s) >= {
        "cache_expired", "cache_evicted", "gate_version", "last_agreement",
        "sigma", "explore_ambiguous", "explore_granted", "explore_denied",
        "fit_deployed", "sentinel",
    }
    assert s["sentinel"]["n"] == 0 and s["sentinel"]["alarmed"] is None
    off = _tier(tmp_path, "off.json", config=AdaptConfig(sentinel=False))
    assert off.sentinel is None and off.stats()["sentinel"] is None
    off.pick(GEMM)
    assert off.refit_now()["trigger"] == "interval"


def test_picks_metrics_and_flushes_under_contention(tmp_path):
    """Request threads hammer AdaptiveTier.pick + Autotuner.pick + a
    shared counter while the background re-fit thread swaps gates and
    flushes the write-behind cache.  Nothing may be lost."""
    cache = AutotuneCache(path=str(tmp_path / "stress.json"))
    tuner = Autotuner(cache=cache, backend="numpy", persist="defer",
                      audit=False)
    tier = AdaptiveTier(tuner, machine=TPU_V5E, device="cpu",
                        config=AdaptConfig(
                            ttl_s=0.05, refit_interval_s=0.01,
                            refit_min_picks=16, buffer_size=128,
                            fit_min_records=10 ** 9,  # gate refits only
                        ))
    gemms = [GemmShape(1024 * 8 * (i + 1), 8192, 8192, 2) for i in range(6)]
    n_threads, iters = 8, 24
    shared = metrics.get_metrics().counter("test/stress")
    errors = []

    def worker(tid):
        try:
            for i in range(iters):
                g = gemms[(tid + i) % len(gemms)]
                if tid % 2:
                    tier.pick(g)
                else:
                    tuner.pick(g, TPU_V5E)
                shared.inc()
        except BaseException as e:  # noqa: BLE001 - the assertion
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with tier:  # background re-fit thread live
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            deadline = time.monotonic() + 10.0
            while tier.gate_version < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            refitter = tier._refitter
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not refitter.is_alive()  # stop() joined it
    assert errors == []
    assert shared.value == n_threads * iters
    tier_picks = (n_threads // 2) * iters
    assert _counter("serve/adapt.decisions") == tier_picks
    assert metrics.get_metrics().histogram(
        "serve/adapt.pick_seconds").count == tier_picks
    assert _counter("serve/adapt.pick.heuristic") == 0
    assert _counter("tuner/pick.heuristic") == 0
    assert not cache.dirty
    on_disk = AutotuneCache(path=cache.path).decision_entries()
    for g in gemms:
        key = str(TuneKey.for_gemm(g, TPU_V5E, None))
        assert key in cache.decision_entries() and key in on_disk
    assert tier.gate_version >= 1


# ---------------------------------------------------------------------------
# The drift loop: alarm -> drift re-fit -> deployed link_bw -> recovery.
# ---------------------------------------------------------------------------

def test_drift_alarm_refit_recovery(tmp_path):
    audit.enable_audit(str(tmp_path / "audit.jsonl"))
    degraded = dataclasses.replace(TPU_V5E, link_bw=TPU_V5E.link_bw * 0.45)
    tier = _tier(
        tmp_path, clock=FakeClock(),
        config=AdaptConfig(explore_rate=0.0, explore_burst=1000.0,
                           refit_min_picks=10 ** 9,  # the machine fit only
                           sentinel_min_samples=4, fit_steps=80),
        measure_fn=simulated_measure_fn(degraded, noise=0.0, seed=0),
    )
    tier.policy.set_sigma(10.0)  # every pick is ambiguous -> measured
    for i in range(8):
        tier.pick(GemmShape(4096 * (i + 1), 8192, 8192, 2))
    st = tier.sentinel.state()
    assert st["alarmed"] == "residual" and st["ewma"] > 0.0
    assert tier.sentinel.should_refit()
    pre_ewma = st["ewma"]

    rep = tier.refit_now()
    assert rep["trigger"] == "drift" and "fit_sigma" in rep
    assert "link_bw" in rep.get("fit_deployed", ())
    assert tier.machine.link_bw < TPU_V5E.link_bw  # calibrated down
    assert tier.machine.name == TPU_V5E.name
    assert TPU_V5E.link_bw == 50e9  # the module constant is untouched
    assert not tier.sentinel.should_refit()  # latch cleared
    assert _counter("serve/adapt.fit_deploys") == 1

    # Post-refit traffic on the same degraded hardware, predicted from
    # the calibrated machine.
    tier.policy.set_sigma(10.0)
    for i in range(6):
        tier.pick(GemmShape(4096 * (i + 1), 8192, 8192 + 1024, 2))
    kinds = [e["kind"] for e in tier.sentinel.events]
    assert kinds == ["sentinel_alarm", "sentinel_refit", "sentinel_recovery"]
    assert tier.sentinel.events[1]["trigger"] == "drift"
    rec = tier.sentinel.events[2]
    assert rec["samples"] >= 4
    assert abs(rec["pre_refit_ewma"]) >= abs(pre_ewma) * 0.5
    # The residual measurably shrinks after the re-fit.
    assert abs(rec["post_mean"]) < 0.5 * abs(rec["pre_refit_ewma"])
    recs = audit.read_audit(str(tmp_path / "audit.jsonl"))
    assert audit.validate_audit(recs) == []
    assert sentinel.validate_sentinel(
        [r for r in recs if r["kind"].startswith("sentinel_")]) == []
    assert [r["kind"] for r in recs].count("adapt_measure") == 14


def test_alarm_hook_and_kick_run_a_cycle_now(tmp_path):
    tier = _tier(tmp_path, config=AdaptConfig(refit_interval_s=60.0))
    assert tier.sentinel.on_alarm is None
    with tier:
        assert tier.sentinel.on_alarm == tier._refitter.kick
        tier._refitter.kick()
        deadline = time.monotonic() + 5.0
        while (_counter("serve/adapt.refits") < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert _counter("serve/adapt.refits") >= 1
        assert tier._refitter.kicks == 1
        refitter = tier._refitter
    assert tier.sentinel.on_alarm is None  # unhooked on stop
    assert not refitter.is_alive()


# ---------------------------------------------------------------------------
# Parity with the reference's AdaptiveTier (the JAX subprocess).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def adapt_runs(tmp_path_factory):
    ref = ref_driver.reference(tmp_path_factory)["adapt"]
    path = str(tmp_path_factory.mktemp("adapt") / "adapt.json")
    return ref, ref_driver.adapt_script("repro_torch", path, device="cpu")


def test_scripted_run_picks_match_reference(adapt_runs):
    ref, port = adapt_runs
    assert len(port["picks"]) == ref_driver.ADAPT["n"]
    assert {p[1] for p in port["picks"]} >= {"analytic", "measured"}
    for got, want in zip(port["picks"], ref["picks"]):
        assert got[:3] == want[:3]  # key, tier, schedule
        for x, y in zip(got[3:], want[3:]):
            if y is None:
                assert x is None
            else:
                assert abs(x - y) <= 1e-12 * abs(y), (got, want)


def test_scripted_run_gate_fit_and_stats_match_reference(adapt_runs):
    ref, port = adapt_runs
    assert port["gate"] == ref["gate"]  # byte for byte
    rr, pr = ref["report"], port["report"]
    assert pr.keys() == rr.keys() and "fit_sigma" in pr
    np.testing.assert_allclose(pr["fit_sigma"], rr["fit_sigma"], rtol=1e-6)
    assert {k: v for k, v in pr.items() if k != "fit_sigma"} == {
        k: v for k, v in rr.items() if k != "fit_sigma"}
    np.testing.assert_allclose(port["link_bw"], ref["link_bw"], rtol=1e-6)
    assert port["link_bw"][1] != port["link_bw"][0]  # deployed
    assert port["machine_name"] == ref["machine_name"]

    def split(stats):
        s = dict(stats)
        sent = dict(s.pop("sentinel"))
        floats = {k: s.pop(k) for k in ("sigma",)}
        floats.update({f"sentinel.{k}": sent.pop(k) for k in ("sigma",)})
        return s, sent, floats

    (ps, psent, pf), (rs, rsent, rf) = split(port["stats"]), split(
        ref["stats"])
    assert ps == rs and psent == rsent
    for k in rf:
        np.testing.assert_allclose(pf[k], rf[k], rtol=1e-6, err_msg=k)
    assert len(port["events"]) == len(ref["events"])
    for pe, re_ in zip(port["events"], ref["events"]):
        assert pe["kind"] == re_["kind"] and pe["n"] == re_["n"]


# ---------------------------------------------------------------------------
# The wiring: DecodeEngine(adapt=...) and launch/serve.py --adapt.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_parts():
    cfg = get_config("smollm-360m").reduced()
    return cfg, build_model(cfg).init(0, device="cpu")


def test_adapt_hook_records_decision_and_span(engine_parts, tmp_path):
    cfg, state = engine_parts
    _trace.enable()
    tier = _tier(tmp_path)
    eng = DecodeEngine(cfg, state, batch_size=2, cache_len=32, device="cpu",
                       adapt=tier)
    plain = DecodeEngine(cfg, state, batch_size=2, cache_len=32,
                         device="cpu")

    def reqs():
        return [Request(np.asarray([1, 2, 3], np.int32), max_new_tokens=3),
                Request(np.asarray([4], np.int32), max_new_tokens=2)]

    got, want = eng.run(reqs()), plain.run(reqs())
    assert [r.out for r in got] == [r.out for r in want]  # decision only
    dec = eng.last_decision
    assert dec.source == "analytic" and isinstance(dec.schedule, Schedule)
    runs = [e for e in _trace.get_tracer().events if e["name"] == "serve/run"]
    assert runs[0]["args"]["overlap_schedule"] == dec.schedule.value
    assert runs[0]["args"]["overlap_tier"] == "analytic"
    assert "overlap_schedule" not in runs[1]["args"]
    # Zero-token batches return before consulting the tier.
    eng.run([Request(np.asarray([1], np.int32), max_new_tokens=0)])
    assert _counter("serve/adapt.decisions") == 1

    class FakeTier:
        calls = 0

        def pick_for_requests(self, requests, c):
            FakeTier.calls += 1
            return ("stub", len(requests))

    eng = DecodeEngine(cfg, state, batch_size=2, cache_len=32, device="cpu",
                       adapt=FakeTier())
    eng.run([Request(np.asarray([1, 2], np.int32), max_new_tokens=2)])
    assert eng.last_decision == ("stub", 1) and FakeTier.calls == 1


def test_launch_serve_adapt_and_signatures(tmp_path, capsys):
    from repro_torch.launch.serve import main

    sig = tmp_path / "sig.jsonl"
    main(["--arch", "tinyllama-1.1b", "--prompts", "2", "--prompt-len",
          "3", "--new-tokens", "2", "--device", "cpu", "--adapt",
          "--adapt-refit-s", "30", "--adapt-ttl", "10",
          "--signatures", str(sig)])
    out = capsys.readouterr().out
    assert "decoded 4 tokens" in out
    line = next(x for x in out.splitlines() if x.startswith("adapt: "))
    assert "schedule=" in line and "'sentinel': {" in line
    assert "signatures: 1 cells -> " + str(sig) in out
    with open(sig) as fh:
        snaps = [json.loads(x) for x in fh]
    assert signature.validate_signature(snaps[0]) == []
    cache = os.path.join(os.environ["REPRO_AUTOTUNE_CACHE_DIR"],
                         "autotune-torch-v2.json")
    assert os.path.exists(cache)  # stop() flushed the write-behind layer
    main(["--arch", "tinyllama-1.1b", "--prompts", "1", "--prompt-len", "2",
          "--new-tokens", "1", "--device", "cpu", "--adapt",
          "--adapt-no-sentinel"])
    assert "'sentinel': None" in capsys.readouterr().out
