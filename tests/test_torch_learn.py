"""The port's learned gate and machine fit (``repro_torch.learn``) vs
``repro.learn`` and ``repro.core``.

``repro.learn``'s features, statistics and gate import without JAX, so
they run in this process on the same seeded inputs: the feature matrices
and the integer gate statistics are compared bit for bit, the trained
gate's JSON byte for byte, the gated heuristic pick for pick.  The
reference's ``fit_machine`` runs on its jax engine, so it runs in the
session's one JAX subprocess (``tests/torch_jax_reference.py``) and the
port's fit on the same synthesized records is held to it at 1e-6
relative.  The machines are the reference's (the port's
``machine_grid()[:8]``: MI300X and TPU v5e), so both sides train on the
same points.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_jax_reference as ref_driver
from repro import learn as jlearn
from repro import sweep as jsweep
from repro.core import engine as jengine
from repro.core import explorer as jexplorer
from repro.core import heuristics as jheuristics
from repro.core import machine as jmachine
from repro.core import workload as jworkload
from repro_torch.autotune import AutotuneCache, TuneKey
from repro_torch.core import TABLE_I, heuristics, synthetic_scenarios
from repro_torch.core.batch import GRID_SCHEDULES, SCHEDULE_INDEX
from repro_torch.core.engine import TorchEngine, get_engine
from repro_torch.core.explorer import explore_grid
from repro_torch.core.heuristics import select_schedule, select_schedule_batch
from repro_torch.core.machine import H100_SXM, MI300X, TPU_V5E, Topology
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import GemmShape, StepProfile, machine_grid
from repro_torch.learn import (
    FEATURE_INDEX,
    FEATURE_NAMES,
    FitResult,
    FittedEngine,
    GateStats,
    LearnedGate,
    MeasuredEngine,
    MeasuredRecord,
    clear_machine_gates,
    fit_machine,
    gate_accuracy,
    get_machine_gate,
    grid_features,
    load_fit,
    load_gate,
    load_machine_gate,
    machine_family,
    records_from_cache,
    refine_gate,
    save_fit,
    save_gate,
    save_machine_gates,
    scenario_features,
    set_default_gate,
    set_machine_gate,
    sweep_stats,
    synthesize_records,
    train_gate,
    train_gate_from_stats,
    train_machine_gates,
    variant_records_from_cache,
)
from repro_torch.obs import metrics
from repro_torch.sweep import synthetic_batch, synthetic_ragged_batch

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

MACHINES = machine_grid()[:ref_driver.N_GRID_MACHINES]
J_MACHINES = jworkload.machine_grid()


@pytest.fixture(autouse=True)
def _no_ambient_state():
    """No leaked process-wide gate, and the frozen default TAU / serial
    gate on both sides (other suites freeze per-machine overrides)."""
    saved = [(dict(m._TAU_OVERRIDES), dict(m._SERIAL_GATE_OVERRIDES))
             for m in (heuristics, jheuristics)]

    def reset():
        for m in (heuristics, jheuristics):
            m._TAU_OVERRIDES.clear()
            m._SERIAL_GATE_OVERRIDES.clear()
        for set_default, clear in ((jlearn.set_default_gate,
                                    jlearn.clear_machine_gates),
                                   (set_default_gate, clear_machine_gates)):
            set_default(None)
            clear()
        metrics.reset_metrics()

    reset()
    yield
    reset()
    for m, (tau, gate) in zip((heuristics, jheuristics), saved):
        m._TAU_OVERRIDES.update(tau)
        m._SERIAL_GATE_OVERRIDES.update(gate)


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    """The JAX subprocess runs while the in-process tests run; the fit
    tests, which need it, come last."""
    ref_driver.start(tmp_path_factory)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return ref_driver.reference(tmp_path_factory)


def _ref_machine(port):
    kw = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    kw["topology"] = jmachine.Topology(port.topology.value)
    return jmachine.MachineSpec(**kw)


def _ref_gate(gate):
    return jlearn.LearnedGate.from_json(gate.to_json())


def _always_serial_gate() -> LearnedGate:
    return LearnedGate(tree={"leaf": True, "gate": float("-inf"), "n": 0,
                             "win5": 0, "regret_q": 0})


@pytest.fixture(scope="module")
def trained():
    """The reference's training recipe (``tests/test_learn.py``) on both
    sides: Dirichlet ragged + uniform synthetic sweeps, reduce mode."""
    def port():
        r, _ = sweep_stats(synthetic_ragged_batch(2000, seed=7), MACHINES,
                           num_shards=8)
        u, _ = sweep_stats(synthetic_batch(2000, seed=8), MACHINES,
                           num_shards=8)
        return r + u

    def ref():
        r, _ = jlearn.sweep_stats(jsweep.synthetic_ragged_batch(2000, seed=7),
                                  J_MACHINES, num_shards=8)
        u, _ = jlearn.sweep_stats(jsweep.synthetic_batch(2000, seed=8),
                                  J_MACHINES, num_shards=8)
        return r + u

    stats, jstats = port(), ref()
    return {"stats": stats, "jstats": jstats,
            "gate": train_gate_from_stats(stats),
            "jgate": jlearn.train_gate_from_stats(jstats)}


# ---- features --------------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("machine", [MI300X, TPU_V5E, H100_SXM],
                         ids=lambda m: m.name)
def test_scenario_features_match_reference(machine, ragged):
    if ragged:
        port, ref = (synthetic_ragged_batch(64, seed=3),
                     jsweep.synthetic_ragged_batch(64, seed=3))
    else:
        port, ref = (synthetic_batch(64, seed=3),
                     jsweep.synthetic_batch(64, seed=3))
    got = scenario_features(port, machine)
    want = jlearn.scenario_features(ref, _ref_machine(machine))
    assert got.shape == (64, len(FEATURE_NAMES))
    np.testing.assert_array_equal(got, want)
    if ragged:
        np.testing.assert_array_equal(got[:, FEATURE_INDEX["active_steps"]],
                                      port.active_steps)
    else:
        assert (got[:, FEATURE_INDEX["active_steps"]] == machine.group).all()


def test_grid_features_match_reference():
    grid = get_engine("numpy").evaluate(synthetic_batch(12, seed=2),
                                        MACHINES[:3])
    jgrid = jengine.get_engine("numpy").evaluate(
        jsweep.synthetic_batch(12, seed=2), J_MACHINES[:3])
    np.testing.assert_array_equal(grid_features(grid),
                                  jlearn.grid_features(jgrid))


# ---- sufficient statistics ---------------------------------------------------

@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_gate_stats_sharded_equals_gathered(engine):
    eng = TorchEngine("cpu") if engine == "torch" else get_engine("numpy")
    rb = synthetic_ragged_batch(400, seed=11)
    sharded, res = sweep_stats(rb, MACHINES[:2], engine=eng, num_shards=7)
    assert res.grid is None
    gathered = GateStats.from_grid(eng.evaluate(rb, MACHINES[:2]))
    np.testing.assert_array_equal(sharded.hist, gathered.hist)
    assert sharded.n_points == gathered.n_points
    assert sharded.best_counts == gathered.best_counts


def test_gate_stats_bit_equal_to_reference(trained):
    stats, jstats = trained["stats"], trained["jstats"]
    np.testing.assert_array_equal(stats.hist, jstats.hist)
    assert stats.best_counts == jstats.best_counts
    assert stats.to_json() == jstats.to_json()


def test_gate_stats_json_and_identity_checks():
    stats, _ = sweep_stats(synthetic_ragged_batch(80, seed=5), MACHINES[:2],
                           num_shards=2)
    assert GateStats.from_json(stats.to_json()).to_json() == stats.to_json()
    raw = json.loads(stats.to_json())
    raw["score_edges"][0] *= 2.0
    with pytest.raises(ValueError):
        GateStats.from_json(json.dumps(raw))
    sub = get_engine("numpy").evaluate(
        synthetic_batch(8), (MI300X,),
        schedules=(Schedule.SERIAL, Schedule.UNIFORM_FUSED_1D))
    with pytest.raises(ValueError, match="GRID_SCHEDULES"):
        GateStats.from_grid(sub)


# ---- the learned gate --------------------------------------------------------

def test_trained_gate_json_byte_equal_to_reference(trained):
    gate, jgate = trained["gate"], trained["jgate"]
    assert gate.to_json() == jgate.to_json()
    assert LearnedGate.from_json(gate.to_json()) == gate
    assert gate.n_leaves > 1
    # Non-finite thresholds encode as the reference's strings.
    g = _always_serial_gate()
    assert g.to_json() == _ref_gate(g).to_json()
    assert '"gate":"-inf"' in g.to_json()


def test_train_gate_from_grid_equals_from_stats():
    rb = synthetic_ragged_batch(500, seed=21)
    stats, _ = sweep_stats(rb, MACHINES[:3], num_shards=9)
    from_grid = train_gate(get_engine("numpy").evaluate(rb, MACHINES[:3]))
    assert train_gate_from_stats(stats).to_json() == from_grid.to_json()


def test_gate_accuracy_matches_reference(trained):
    """The held-out grids of the reference's headline test: the port's
    gated heuristic scores exactly what the reference's does."""
    gate, jgate = trained["gate"], trained["jgate"]
    grid = get_engine("numpy").evaluate(
        synthetic_ragged_batch(1500, seed=99), MACHINES)
    jgrid = jengine.get_engine("numpy").evaluate(
        jsweep.synthetic_ragged_batch(1500, seed=99), J_MACHINES)
    acc = gate_accuracy(grid, gate)
    assert acc == jlearn.gate_accuracy(jgrid, jgate)
    assert gate_accuracy(grid) == jlearn.gate_accuracy(jgrid)
    assert acc >= 0.75 and acc > gate_accuracy(grid)


def test_refine_gate_matches_reference():
    rb = synthetic_ragged_batch(400, seed=31)
    stats, _ = sweep_stats(rb, MACHINES[:3], num_shards=4)
    gate = train_gate_from_stats(stats)
    grid = get_engine("numpy").evaluate(rb, MACHINES[:3])
    refined = refine_gate(gate, grid)
    jgrid = jengine.get_engine("numpy").evaluate(
        jsweep.synthetic_ragged_batch(400, seed=31), J_MACHINES[:3])
    assert refined.to_json() == jlearn.refine_gate(_ref_gate(gate),
                                                   jgrid).to_json()
    info = refined.meta["refine"]
    assert info["regret_q_after"] <= info["regret_q_before"]
    with pytest.raises(ValueError, match="sub_bins"):
        refine_gate(gate, grid, sub_bins=0)


def test_select_schedule_gate_scalar_batch_and_reference(trained):
    """select_schedule(gate=) == select_schedule_batch(gate=) == the
    reference's picks, over random shapes x machines x profiles."""
    gate = trained["gate"]
    jgate = _ref_gate(gate)
    rng = np.random.default_rng(17)
    S = 48
    m = 1024 * rng.integers(1, 512, S)
    n = 128 * rng.integers(1, 256, S)
    k = 128 * rng.integers(1, 256, S)
    b = rng.choice([1, 2], size=S)
    profiles = []
    for i in range(S):
        if i % 3 == 0:
            profiles.append(None)
        else:
            w = rng.random(int(rng.integers(2, 9))) + 0.05
            if i % 3 == 2 and w.size > 2:
                w[-(w.size // 3):] = 0.0
            profiles.append(StepProfile.from_weights(w))
    for machine in (MI300X, TPU_V5E, MACHINES[3], H100_SXM):
        jm = _ref_machine(machine)
        imb = np.array([1.0 if p is None else p.imbalance for p in profiles])
        act = np.array([float(machine.group) if p is None else p.active_steps
                        for p in profiles])
        got = select_schedule_batch(m, n, k, b, machine, gate=gate,
                                    imbalance=imb, active_steps=act)
        want = jheuristics.select_schedule_batch(
            m, n, k, b, jm, gate=jgate, imbalance=imb, active_steps=act)
        np.testing.assert_array_equal(got, want)
        for i in range(S):
            gemm = GemmShape(int(m[i]), int(n[i]), int(k[i]), int(b[i]))
            prof = profiles[i]
            dec = select_schedule(gemm, machine, gate=gate, profile=prof)
            jdec = jheuristics.select_schedule(
                jworkload.GemmShape(gemm.m, gemm.n, gemm.k, gemm.dtype_bytes),
                jm, gate=jgate,
                profile=None if prof is None else jworkload.StepProfile(
                    prof.fractions, prof.name))
            assert got[i] == SCHEDULE_INDEX[dec.schedule]
            assert (dec.schedule.value, dec.reason) == (
                jdec.schedule.value, jdec.reason)


def test_explore_grid_and_gate_agreement_with_gate(trained):
    gate = trained["gate"]
    ex = explore_grid(TABLE_I, machines=[MI300X, TPU_V5E], gate=gate)
    jex = jexplorer.explore_grid(
        jworkload.TABLE_I, machines=[_ref_machine(MI300X),
                                     _ref_machine(TPU_V5E)],
        gate=_ref_gate(gate))
    np.testing.assert_array_equal(ex.heuristic_idx, jex.heuristic_idx)
    assert ex.accuracy(0.05) == jex.accuracy(0.05)
    rate = metrics.observe_gate_agreement(ex.grid, gate=gate)
    from repro.obs import metrics as jmetrics

    assert rate == jmetrics.observe_gate_agreement(
        jex.grid, gate=_ref_gate(gate), registry=jmetrics.MetricsRegistry())


def test_family_gates_route_the_tree_and_persist(tmp_path):
    gemm = TABLE_I[1].gemm
    base = select_schedule(gemm, MI300X).schedule
    assert base is not Schedule.SERIAL
    set_machine_gate(MI300X, _always_serial_gate())
    assert select_schedule(gemm, MI300X).schedule is Schedule.SERIAL
    assert select_schedule(gemm, TPU_V5E).schedule is not Schedule.SERIAL
    never = LearnedGate(tree={"leaf": True, "gate": float("inf")})
    assert select_schedule(gemm, MI300X, gate=never).schedule is base
    clear_machine_gates()

    machines = machine_grid(groups=(8,))
    assert {machine_family(m) for m in machines} == {
        "mi300x-8", "tpu-v5e-axis16", "h100-sxm-8"}
    grid = get_engine("numpy").evaluate(synthetic_batch(300, seed=12),
                                        machines)
    full, parts = GateStats.from_grid(grid), {}
    for fam in dict.fromkeys(machine_family(m) for m in machines):
        st = GateStats.empty()
        st.update_from_grid(grid, machine_indices=[
            j for j, m in enumerate(machines) if machine_family(m) == fam])
        parts[fam] = st
    summed = sum(parts.values(), GateStats.empty())
    np.testing.assert_array_equal(summed.hist, full.hist)
    gates = train_machine_gates(parts, install=True)
    assert get_machine_gate("h100-sxm-8/g8/torus_ring") is gates["h100-sxm-8"]
    cache = AutotuneCache(path=str(tmp_path / "c.json"))
    save_machine_gates(gates, cache=cache)
    for fam, g in gates.items():
        assert load_machine_gate(fam, cache=cache).to_json() == g.to_json()
    assert load_gate(cache=cache) is None
    save_gate(gates["h100-sxm-8"], cache=cache)
    assert load_gate(cache=cache) == gates["h100-sxm-8"]


# ---- the measured engine -----------------------------------------------------

def test_measured_engine_shortlist_only_with_override():
    eng = get_engine("measured")
    assert (eng.name, eng.supports_ragged, eng.jit, eng.differentiable,
            eng.trace_safe) == ("measured", True, False, False, True)
    sb = synthetic_batch(6, seed=1)
    base = get_engine("numpy").evaluate(sb, (MI300X,))
    cache = AutotuneCache(path=None)
    cache.entries.clear()
    l0 = int(base.best_idx()[0, 0])
    t_meas = 0.5 * float(base.total[l0, 0, 0])
    cache.put(str(TuneKey.for_gemm(sb.gemm(0), MI300X)),
              {"schedule": base.schedules[l0].value, "source": "measured",
               "model_total_s": None, "measured_total_s": t_meas},
              persist=False)
    grid = MeasuredEngine(cache, top=3).evaluate(sb, (MI300X,))
    assert (grid.valid.sum(axis=0) <= 4).all()
    assert grid.valid[GRID_SCHEDULES.index(Schedule.SERIAL)].all()
    assert grid.total[l0, 0, 0] == t_meas
    assert np.isnan(grid.total[~grid.valid]).all()


# ---- the machine fit ---------------------------------------------------------

def _fit_records(reference):
    return [MeasuredRecord(GemmShape(*g), Schedule(s), t, MI300X.group)
            for g, s, t in reference["fit_records"]]


def test_synthesize_records_match_reference(reference):
    true = {"link_bw": MI300X.link_bw * ref_driver.FIT_TRUE["link_bw_scale"],
            "s_half": ref_driver.FIT_TRUE["s_half"]}
    got = synthesize_records(
        MI300X, [s.gemm for s in synthetic_scenarios(12)],
        (Schedule.SERIAL, Schedule.UNIFORM_FUSED_1D,
         Schedule.HETERO_UNFUSED_1D),
        overrides=true, device="cpu")
    want = _fit_records(reference)
    assert [(r.gemm, r.schedule) for r in got] == [
        (r.gemm, r.schedule) for r in want]
    np.testing.assert_allclose([r.seconds for r in got],
                               [r.seconds for r in want], rtol=1e-9, atol=0)


def test_fit_machine_matches_reference_and_recovers(reference, tmp_path):
    """The reference's recovery test on both engines: the same records,
    the same Adam; fitted values within 1e-6 relative of the reference's
    and within 5% of the perturbed truth."""
    fit = fit_machine(MI300X, _fit_records(reference),
                      params=("link_bw", "s_half"),
                      steps=ref_driver.FIT_STEPS, device="cpu")
    want = reference["fit"]
    assert fit.initial == pytest.approx(want["initial"], rel=1e-12)
    assert fit.loss0 == pytest.approx(want["loss0"], rel=1e-9)
    for name in ("link_bw", "s_half"):
        assert fit.fitted[name] == pytest.approx(want["fitted"][name],
                                                 rel=1e-6)
    assert fit.loss < fit.loss0
    true = {"link_bw": MI300X.link_bw * ref_driver.FIT_TRUE["link_bw_scale"],
            "s_half": ref_driver.FIT_TRUE["s_half"]}
    for name, target in true.items():
        assert abs(fit.fitted[name] / target - 1.0) < 0.05
    # Persistence through the port's cache; a schema bump invalidates.
    cache = AutotuneCache(path=str(tmp_path / "c.json"))
    save_fit(fit, cache=cache)
    assert load_fit(f"{fit.machine}/g{fit.group}", cache=cache) == fit
    raw = fit.to_payload()
    raw["version"] += 1
    with pytest.raises(ValueError):
        FitResult.from_payload(raw)


def test_fitted_engine_and_variant_spec_survive():
    variant = next(m for m in MACHINES if m.topology is Topology.TORUS_RING)
    gemms = [s.gemm for s in synthetic_scenarios(4)]
    records = synthesize_records(variant, gemms, (Schedule.SERIAL,),
                                 overrides={"link_bw": variant.link_bw * 2},
                                 device="cpu")
    fit = fit_machine(variant, records, params=("link_bw",), steps=40,
                      device="cpu")
    back = FitResult.from_payload(fit.to_payload())
    assert back.spec() == variant
    assert not bool(back.machine_arrays(device="cpu").is_mesh[0])
    grid = FittedEngine(back, device="cpu").evaluate(gemms, [variant, MI300X])
    plain = TorchEngine("cpu").evaluate(gemms, [variant, MI300X])
    np.testing.assert_array_equal(grid.total[:, :, 1], plain.total[:, :, 1])
    assert (grid.serial_comm[:, 0] < plain.serial_comm[:, 0]).all()


def test_records_from_cache_parse_tunekeys():
    cache = AutotuneCache(path=None)
    cache.entries.clear()
    mach = MACHINES[0]  # the name contains '/': the parsing edge case
    gemm = GemmShape(8192, 4096, 2048, 2)
    cache.put(str(TuneKey.for_gemm(gemm, mach)),
              {"schedule": "serial", "source": "measured",
               "model_total_s": None, "measured_total_s": 1.25e-3},
              persist=False)
    cache.put(str(TuneKey.for_gemm(GemmShape(1024, 1024, 1024), mach)),
              {"schedule": "serial", "source": "analytic",
               "model_total_s": 1e-3, "measured_total_s": None},
              persist=False)
    skewed = StepProfile.from_weights([3.0, 1.0, 1.0, 1.0], name="uneven")
    cache.put(str(TuneKey.for_gemm(gemm, mach, profile=skewed)),
              {"schedule": "serial", "source": "measured",
               "model_total_s": None, "measured_total_s": 9e-4},
              persist=False)
    assert records_from_cache(cache, mach.name) == [
        MeasuredRecord(gemm, Schedule.SERIAL, 1.25e-3, mach.group)]
    key = str(TuneKey.for_gemm(gemm, mach, profile=skewed,
                               variant="c4t128x128x256d2f"))
    cache.put(key, {"schedule": "uniform-fused-1d", "source": "measured",
                    "measured_total_s": 2e-4, "kernel": "dma_exchange",
                    "variant": "c4t128x128x256d2f",
                    "profile_frac": [0.5, 1 / 6, 1 / 6, 1 / 6]},
              persist=False)
    [rec] = variant_records_from_cache(cache, mach.name)
    assert (rec.variant, rec.schedule, rec.seconds) == (
        "c4t128x128x256d2f", Schedule.UNIFORM_FUSED_1D, 2e-4)
    assert rec.profile == (0.5, 1 / 6, 1 / 6, 1 / 6)
