"""The port's runtime tuner (``repro_torch.autotune``) and its provenance
(``repro_torch.obs.audit``, ``signature``, ``timeline``), in process.

``repro.autotune`` does not import on this tree (jax 0.9.0 dropped
``jax.experimental.enable_x64``, ROADMAP R1), so the tuner is held against
what of the reference does: its analytic ranking against
``repro.core.engine.shortlist`` on the ``"numpy"`` engine filtered by
``repro.overlap.api._divisible``, its keys against the reference's key
literals, the timeline and the signature stream against ``repro.obs``.
``measure`` runs on the CPU at a tiny shape (the card's CUDA-event timing
runs in ``chip_smoke.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

from repro import learn as jlearn
from repro.core import engine as jengine
from repro.core import machine as jmachine
from repro.core import simulator as jsim
from repro.core import workload as jworkload
from repro.core.schedule_types import Schedule as JSchedule
from repro.obs import signature as jsignature
from repro.obs import timeline as jtimeline
from repro.overlap.api import _divisible as ref_divisible
from repro_torch.autotune import (
    AutotuneCache,
    Autotuner,
    TuneKey,
    autotune_schedule,
    get_tuner,
    reset_tuner,
    set_tuner,
)
from repro_torch.autotune import cache as cache_mod
from repro_torch.core import explorer, simulator
from repro_torch.core.engine import shortlist
from repro_torch.core.heuristics import select_schedule
from repro_torch.core.machine import H100_SXM, MI300X, TPU_V5E
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import TABLE_I, GemmShape
from repro_torch.learn import (
    LearnedGate,
    MeasuredEngine,
    clear_machine_gates,
    machine_family,
    save_gate,
    save_machine_gates,
    set_default_gate,
    set_machine_gate,
)
from repro_torch.obs import audit, metrics, signature, timeline
from repro_torch.obs import trace as _trace
from repro_torch.overlap import api, schedules
from repro_torch.parallel.sharding import shard_columns, shard_rows
from repro_torch.tune import KernelVariant, registry

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

MACHINES = (MI300X, TPU_V5E, H100_SXM)


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """The port's process-wide tuner, promotions, audit log, signature
    stream, metrics and learned gates (``tests/conftest.py`` resets the
    reference's only)."""

    def reset():
        reset_tuner()
        registry.reset_variants()
        audit.disable_audit()
        signature._STREAM = None
        metrics.reset_metrics()
        set_default_gate(None)
        clear_machine_gates()

    reset()
    yield
    reset()


@pytest.fixture
def tuner(tmp_path):
    return Autotuner(AutotuneCache(path=str(tmp_path / "c.json")),
                     audit=False)


def _ref_machine(port):
    import dataclasses

    kw = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    kw["topology"] = jmachine.Topology(port.topology.value)
    return jmachine.MachineSpec(**kw)


def _ref_gemm(g):
    return jworkload.GemmShape(g.m, g.n, g.k, g.dtype_bytes)


def _shards(m, n, k, g=4, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return shard_rows(x.to(dtype), g), shard_columns(w.to(dtype), g)


def test_tune_keys_match_the_reference_literals():
    gemm = GemmShape(65536, 4096, 8192, 2)
    assert str(TuneKey.for_gemm(gemm, TPU_V5E)) == (
        "tpu-v5e-axis16/g16/m65536/n4096/k8192/b2/u16")
    v = KernelVariant("dma_exchange", 4, 128, 128, 256)
    key = TuneKey.for_gemm(GemmShape(2048, 5632, 2048, 2), H100_SXM, 4,
                           variant=v)
    assert str(key) == (
        "h100-sxm-8/g4/m2048/n5632/k2048/b2/u4/vc4t128x128x256d2f")
    assert str(key) == str(TuneKey.for_gemm(
        GemmShape(2048, 5632, 2048, 2), H100_SXM, 4,
        variant="c4t128x128x256d2f"))
    from repro_torch.core.workload import StepProfile

    skew = StepProfile.from_weights([3.0, 1.0], name="skew")
    jskew = jworkload.StepProfile.from_weights([3.0, 1.0], name="skew")
    assert TuneKey.for_gemm(gemm, MI300X, 2, profile=skew).profile == (
        jskew.digest())


@pytest.mark.parametrize("machine", MACHINES, ids=lambda m: m.name)
@pytest.mark.parametrize("group", [2, 4, 8])
def test_analytic_ranking_matches_reference_shortlist(machine, group, tuner):
    """``pick``'s analytic tier: the reference's numpy-engine ranking,
    filtered by the reference runtime's divisibility rule; the winner is
    recorded at the key and a second pick hits the cache."""
    ref_m = jmachine.machine_for_group(_ref_machine(machine), group)
    for sc in TABLE_I[:6]:
        gemm = sc.gemm
        want = [
            (s.value, t) for s, t in jengine.shortlist(
                _ref_gemm(gemm), ref_m, top=len(jengine.GRID_SCHEDULES),
                backend="numpy")
            if (gemm.m % group == 0 and ref_divisible(
                gemm.m // group, gemm.k, group, s))
            or (gemm.m % group and s is JSchedule.SERIAL)
        ]
        got = tuner.executable_ranking(gemm, machine, group=group)
        assert [(s.value, t) for s, t in got] == want
        dec = tuner.pick(gemm, machine, group=group)
        assert (dec.source, dec.schedule.value, dec.model_total_s) == (
            "analytic", *want[0])
        assert [list(p) for p in dec.shortlist] == [list(p)
                                                    for p in want[:3]]
        again = tuner.pick(gemm, machine, group=group)
        assert (again.source, again.schedule) == ("cache", dec.schedule)
    assert tuner.hits == tuner.misses == 6


def test_default_machine_backend_and_gate(tuner):
    assert tuner.backend == "numpy"
    assert tuner.pick(GemmShape(2048, 5632, 2048, 2), group=4).key == (
        "h100-sxm-8/g4/m2048/n5632/k2048/b2/u4")
    assert autotune_schedule(2048, 5632, 2048, group=4) is Schedule.SERIAL
    with pytest.raises(ValueError, match="jax"):
        Autotuner(backend="jax")
    gate = LearnedGate(tree={"leaf": True, "gate": float("inf")})
    assert Autotuner(gate=gate, audit=False).gate is gate
    tuner.set_gate(gate)
    assert tuner.gate is gate and tuner.learned_gate(MI300X) is gate
    tuner.set_gate(None)
    assert tuner.gate is None and tuner.learned_gate(MI300X) is None


def test_pick_falls_back_to_the_heuristic_and_does_not_persist(
        tuner, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("engine down")

    monkeypatch.setattr(tuner, "_shortlist", broken)
    gemm = GemmShape(4096, 8192, 2048, 2)
    dec = tuner.pick(gemm, MI300X, group=8)
    from repro_torch.core.heuristics import select_schedule
    from repro_torch.core.machine import machine_for_group

    want = select_schedule(gemm, machine_for_group(MI300X, 8))
    assert (dec.source, dec.schedule) == ("heuristic", want.schedule)
    assert dec.gate == {"kind": None, "metric": want.metric,
                        "threshold": want.threshold, "reason": want.reason}
    assert len(tuner.cache) == 0
    assert metrics.tuner_tier_rates() == {
        "cache": 0.0, "analytic": 0.0, "measured": 0.0, "heuristic": 1.0}


def test_cache_stamp_name_deferred_flush_and_artifacts(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE_DIR", str(tmp_path))
    path = cache_mod.default_cache_path()
    assert os.path.basename(path) == "autotune-torch-v2.json"
    # The reference's file beside it is never read nor written.
    ref_path = tmp_path / "autotune-v2.json"
    ref_path.write_text(json.dumps({"schema": 2, "jax": "0.9.0",
                                    "entries": {"a/g1": {"schedule": "x"}}}))
    c = AutotuneCache()
    assert c.path == path and len(c) == 0
    c.put("k/g4", {"schedule": "serial"}, persist="defer")
    assert c.dirty and not os.path.exists(path)
    c.put_artifact("kernel_variant", "*/dma_exchange/uniform", {"chunks": 2},
                   persist="defer")
    c.flush()
    assert not c.dirty
    raw = json.load(open(path))
    assert {k: raw[k] for k in ("schema", "torch", "cuda", "device")} == {
        "schema": 2, **cache_mod._stamp()}
    d = AutotuneCache()
    assert d.get("k/g4") == {"schedule": "serial"}
    assert d.get_artifact("kernel_variant", "*/dma_exchange/uniform") == {
        "chunks": 2}
    assert d.artifact_names("kernel_variant") == ("*/dma_exchange/uniform",)
    assert d.decision_entries() == {"k/g4": {"schedule": "serial"}}
    assert json.loads(ref_path.read_text())["entries"] == {
        "a/g1": {"schedule": "x"}}
    # A foreign stamp (another torch, CUDA or card) reads as empty, and a
    # corrupt file too.
    raw["device"] = "another card"
    with open(path, "w") as f:
        json.dump(raw, f)
    assert len(AutotuneCache()) == 0
    with open(path, "w") as f:
        f.write("{not json")
    assert len(AutotuneCache()) == 0
    with pytest.raises(ValueError, match="persist"):
        d.put("x", {}, persist="later")


def test_measure_times_on_the_cpu_and_records(tuner):
    x, w = _shards(64, 32, 16)
    dec = tuner.measure(x, w, schedules=list(Schedule), iters=2)
    assert dec.source == "measured"
    assert dec.key == "h100-sxm-8/g4/m64/n32/k16/b4/u4"
    assert {s for s, _ in dec.shortlist} == {s.value for s in Schedule}
    assert all(t > 0 for _, t in dec.shortlist)
    assert dec.measured_total_s == min(t for _, t in dec.shortlist)
    entry = tuner.cache.get(dec.key)
    assert (entry["schedule"], entry["source"]) == (dec.schedule.value,
                                                    "measured")
    again = tuner.pick(GemmShape(64, 32, 16, 4), group=4)
    assert (again.source, again.schedule) == ("cache", dec.schedule)
    # 6 shard rows do not chunk 4 ways: the 1D FiCCO schedules are dropped
    # before timing; serial, shard_p2p and 2D (K 16 % 4 == 0) stay.
    x6, w6 = _shards(24, 32, 16)
    dec6 = tuner.measure(x6, w6, schedules=list(Schedule), iters=1)
    assert {s for s, _ in dec6.shortlist} == {
        "serial", "shard_p2p", "uniform-fused-2d"}


def test_measure_lets_a_failing_candidate_raise(tuner, monkeypatch):
    def broken(x, w):
        raise RuntimeError("launch failed")

    monkeypatch.setitem(schedules.SCHEDULE_FNS,
                        Schedule.UNIFORM_FUSED_1D, broken)
    x, w = _shards(64, 32, 16)
    with pytest.raises(RuntimeError, match="launch failed"):
        tuner.measure(x, w, schedules=[Schedule.SERIAL,
                                       Schedule.UNIFORM_FUSED_1D])
    assert tuner.cache.get("h100-sxm-8/g4/m64/n32/k16/b4/u4") is None


def test_measure_variants_without_a_runner_is_the_cost_model(tuner):
    from repro_torch.tune import enumerate_variants, variant_cost

    gemm = GemmShape(2048, 5632, 2048, 2)
    vs = enumerate_variants("dma_exchange", H100_SXM, group=4)[:3]
    out = tuner.measure_variants("dma_exchange", gemm, vs, group=4)
    assert out == [(v, variant_cost(v, gemm, H100_SXM, group=4)) for v in vs]
    for v, t in out:
        e = tuner.cache.get(str(TuneKey.for_gemm(gemm, H100_SXM, 4,
                                                  variant=v)))
        assert (e["source"], e["model_total_s"], e["kernel"]) == (
            "variant-model", t, "dma_exchange")


@pytest.mark.parametrize("name", ["serial", "uniform-fused-1d",
                                  "uniform-fused-2d"])
def test_ficco_linear_autotune_runs_what_it_resolves(name):
    """``schedule="autotune"`` against the named schedule its decision
    names (a measured record seeds the decision), 1e-5 f32; the
    resolutions are counted, none falls back."""
    x, w = _shards(256, 128, 128, seed=3)
    key = "h100-sxm-8/g4/m256/n128/k128/b4/u4"
    get_tuner().cache.put(key, {"schedule": name, "source": "measured"},
                          persist=False)
    got = api.ficco_linear(x, w, schedule="autotune")
    want = api.ficco_linear(x, w, schedule=name)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    counters = metrics.get_metrics().snapshot()["counters"]
    assert counters["overlap/resolve.autotune"] == 1
    assert "overlap/resolve.autotune_fallback" not in counters
    assert counters["tuner/pick.cache"] == 1


def test_resolve_autotune_falls_back_when_the_tuner_raises(monkeypatch):
    def broken():
        raise RuntimeError("no tuner")

    monkeypatch.setattr(api, "get_tuner", broken)
    got = api.resolve_schedule("autotune", m=2048, n=5632, k=2048, group=4)
    assert got is Schedule.SERIAL
    counters = metrics.get_metrics().snapshot()["counters"]
    assert counters["overlap/resolve.autotune_fallback"] == 1


def test_audit_records_and_replays_through_the_port_tuner(tmp_path):
    log = audit.AuditLog(str(tmp_path / "a.jsonl"))
    t = Autotuner(AutotuneCache(path=str(tmp_path / "c.json")), audit=log)
    for sc in TABLE_I[:4]:
        t.pick(sc.gemm, MI300X, group=8)
        t.pick(sc.gemm, MI300X, group=8)
    x, w = _shards(64, 32, 16)
    t.measure(x, w, schedules=[Schedule.SERIAL], iters=1)
    recs = audit.read_audit(log.path)
    assert [r["source"] for r in recs] == ["analytic", "cache"] * 4 + [
        "measured"]
    assert audit.validate_audit(recs) == []
    res = audit.replay(log.path)
    assert res.ok and (res.total, res.replayed, res.matched) == (9, 8, 8)
    assert os.path.basename(audit.default_audit_path()) == (
        "decisions-torch.jsonl")


def _strip_clock(events):
    """Trace events without the tracer clock's timestamps (the timeline's
    own, simulated, times stay)."""
    return [{k: v for k, v in e.items()
             if k != "ts" or str(e.get("cat", "")).startswith("timeline")}
            for e in events]


def test_timeline_and_signature_match_reference():
    port_m, ref_m = H100_SXM, _ref_machine(H100_SXM)
    for sc in TABLE_I[:4]:
        for s in Schedule:
            steps = simulator.schedule_steps(sc.gemm, port_m, s)
            want = jsim.schedule_steps(_ref_gemm(sc.gemm), ref_m,
                                       JSchedule(s.value))
            assert timeline.lane_intervals(steps) == (
                jtimeline.lane_intervals(want))
            assert timeline.inefficiency_signature(steps) == (
                jtimeline.inefficiency_signature(want))
            got = signature.decision_signature(sc.gemm, port_m, s, group=4)
            ref = jsignature.decision_signature(
                _ref_gemm(sc.gemm), ref_m, JSchedule(s.value), group=4)
            assert got == ref
        tr, sig = timeline.schedule_timeline(sc.gemm, port_m,
                                             Schedule.UNIFORM_FUSED_1D)
        jtr, jsig = jtimeline.schedule_timeline(
            _ref_gemm(sc.gemm), ref_m, JSchedule.UNIFORM_FUSED_1D)
        assert sig == jsig
        assert _strip_clock(tr.events) == _strip_clock(jtr.events)
        assert _trace.validate_trace(tr.to_json()) == []


def test_signature_stream_observes_tuner_decisions(tuner):
    stream = signature.enable_signatures()
    for sc in TABLE_I[:3]:
        tuner.pick(sc.gemm, H100_SXM, group=4)
        tuner.pick(sc.gemm, H100_SXM, group=4)
    snap = stream.snapshot()
    assert signature.validate_signature(snap) == []
    assert sum(c["count"] for c in snap["cells"]) == 6
    assert sum(sum(c["sources"].values()) for c in snap["cells"]) == 6
    assert {s for c in snap["cells"] for s in c["sources"]} == {
        "analytic", "cache"}


def test_gate_agreement_matches_reference():
    from repro.core import explorer as jexplorer
    from repro.obs import metrics as jmetrics

    ex = explorer.explore_grid(TABLE_I, machines=[MI300X, H100_SXM],
                               backend="numpy")
    jex = jexplorer.explore_grid(
        [jworkload.Scenario(sc.name, sc.parallelism, sc.model,
                            _ref_gemm(sc.gemm)) for sc in TABLE_I],
        machines=[_ref_machine(MI300X), _ref_machine(H100_SXM)],
        backend="numpy")
    rate = metrics.observe_gate_agreement(ex.grid)
    assert rate == jmetrics.observe_gate_agreement(
        jex.grid, registry=jmetrics.MetricsRegistry())
    counters = metrics.get_metrics().snapshot()["counters"]
    assert counters["gate/points"] == ex.grid.total.shape[1] * 2
    gate = LearnedGate(tree={"leaf": True, "gate": 1.0})
    assert metrics.observe_gate_agreement(ex.grid, gate=gate) == (
        jmetrics.observe_gate_agreement(
            jex.grid, gate=jlearn.LearnedGate.from_json(gate.to_json()),
            registry=jmetrics.MetricsRegistry()))


def test_set_tuner_is_what_autotune_consults(tuner):
    set_tuner(tuner)
    assert get_tuner() is tuner
    autotune_schedule(2048, 5632, 2048, group=4)
    assert tuner.misses == 1


def test_launch_serve_takes_the_autotune_mode(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "tinyllama-1.1b", "--prompts", "1", "--prompt-len", "3",
          "--new-tokens", "2", "--overlap-mode", "ficco_autotune",
          "--device", "cpu"])
    assert "decoded 2 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The learned gate in the tuner (ROADMAP A4 step 2)
# ---------------------------------------------------------------------------

def _always_serial_gate():
    return LearnedGate(tree={"leaf": True, "gate": float("-inf"), "n": 0,
                             "win5": 0, "regret_q": 0})


def test_autotuner_consults_learned_gate(tmp_path, monkeypatch):
    """The heuristic fallback applies the learned family ahead of the
    scalar gate: explicitly, via the process default (re-checked per
    call) and via the cache's artifact segment; a malformed artifact
    degrades to the scalar-gated tree (the reference's test)."""
    def fresh(tag):
        return AutotuneCache(path=str(tmp_path / f"{tag}.json"))

    gemm = TABLE_I[1].gemm
    baseline = select_schedule(gemm, MI300X).schedule
    assert baseline is not Schedule.SERIAL

    def boom(self, *a, **kw):
        raise RuntimeError("force the heuristic fallback")

    monkeypatch.setattr(Autotuner, "_shortlist", boom)
    serial_gate = _always_serial_gate()
    dec = Autotuner(fresh("a"), gate=serial_gate, audit=False).pick(
        gemm, MI300X)
    assert dec.schedule is Schedule.SERIAL and dec.source == "heuristic"
    assert dec.gate["kind"] == "LearnedGate"
    assert "sweep-learned gate family" in dec.gate["reason"]

    t2 = Autotuner(fresh("b"), audit=False)
    assert t2.pick(gemm, MI300X).schedule is baseline
    set_default_gate(serial_gate)
    assert t2.pick(gemm, MI300X).schedule is Schedule.SERIAL
    set_default_gate(None)
    assert t2.pick(gemm, MI300X).gate["kind"] is None

    cache = fresh("c")
    save_gate(serial_gate, cache=cache)
    assert Autotuner(cache, audit=False).pick(
        gemm, MI300X).schedule is Schedule.SERIAL

    broken = LearnedGate(tree={"feature": "no-such-feature", "edge": 1.0,
                               "lo": {"leaf": True, "gate": 0.0},
                               "hi": {"leaf": True, "gate": 0.0}})
    cache5 = fresh("e")
    save_gate(broken, cache=cache5)
    assert Autotuner(cache5, audit=False).pick(
        gemm, MI300X).schedule is baseline


def test_tuner_resolves_family_before_default(tmp_path):
    """``learned_gate(machine)``: ambient family > ambient default > family
    artifact > default artifact."""
    fam_gate = _always_serial_gate()
    default_gate = LearnedGate(tree={"leaf": True, "gate": 99.0})
    cache = AutotuneCache(path=str(tmp_path / "c.json"))
    save_machine_gates({machine_family(H100_SXM): fam_gate}, cache=cache)
    save_gate(default_gate, cache=cache)
    t = Autotuner(cache, audit=False)
    assert t.learned_gate(H100_SXM).to_json() == fam_gate.to_json()
    assert t.learned_gate().to_json() == default_gate.to_json()
    assert t.learned_gate(MI300X).to_json() == default_gate.to_json()
    ambient = LearnedGate(tree={"leaf": True, "gate": 7.0})
    set_default_gate(ambient)
    assert t.learned_gate(MI300X) is ambient
    set_machine_gate(H100_SXM, ambient)
    assert t.learned_gate(H100_SXM) is ambient
    clear_machine_gates()
    set_default_gate(None)
    assert t.learned_gate(H100_SXM).to_json() == fam_gate.to_json()


def test_analytic_pick_carries_the_gate_verdict(tuner):
    """With a learned gate installed, an analytic decision records what the
    gated tree picks beside the analytic winner; without one it records
    nothing, as the reference does."""
    gemm = GemmShape(2048, 5632, 2048, 2)
    plain = tuner.pick(gemm, H100_SXM, group=4)
    assert (plain.source, plain.gate) == ("analytic", None)
    tuner.set_gate(_always_serial_gate())
    tuner.cache.entries.clear()
    dec = tuner.pick(gemm, H100_SXM, group=4)
    assert dec.source == "analytic" and dec.schedule is plain.schedule
    assert dec.gate["kind"] == "LearnedGate"
    assert dec.gate["schedule"] == Schedule.SERIAL.value
    assert "sweep-learned" in dec.gate["reason"]


def test_measured_engine_shortlist_ranks_from_records(tmp_path):
    """The ``"measured"`` engine's shortlist puts a measured record ahead of
    the model's ranking; unmeasured keys keep the model's order."""
    gemm = GemmShape(2048, 5632, 2048, 2)
    cache = AutotuneCache(path=str(tmp_path / "c.json"))
    model = shortlist(gemm, H100_SXM, top=3)
    runner_up = model[1][0]
    cache.put(str(TuneKey.for_gemm(gemm, H100_SXM)),
              {"schedule": runner_up.value, "source": "measured",
               "model_total_s": None,
               "measured_total_s": 0.5 * model[0][1]}, persist=False)
    ranked = shortlist(gemm, H100_SXM, top=3, engine=MeasuredEngine(cache))
    assert ranked[0] == (runner_up, 0.5 * model[0][1])
    other = GemmShape(4096, 5632, 2048, 2)
    assert shortlist(other, H100_SXM, top=3,
                     engine=MeasuredEngine(cache)) == shortlist(
        other, H100_SXM, top=3)
