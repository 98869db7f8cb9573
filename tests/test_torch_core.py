"""The port's analytic core vs ``repro.core``, bit for bit.

Both sides are NumPy on the host with the same formulas in the same
accumulation order, so every number is compared with ``==`` (or
``np.array_equal``), not a tolerance: the simulator and its step IR, the
loss decomposition, both grid engines on uniform and ragged scenarios,
the explorer, the batched heuristic and its calibrations, and the
workload grids.  ``repro.core`` imports no JAX, so the reference runs in
this process.  The machines are MI300X, TPU v5e and the port's H100_SXM,
which the reference reads as a ``MachineSpec`` built from its fields.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core import explorer as jexplorer
from repro.core import heuristics as jheuristics
from repro.core import inefficiency as jineff
from repro.core import machine as jmachine
from repro.core import simulator as jsim
from repro.core import workload as jworkload
from repro.core.schedule_types import Schedule as JSchedule
from repro_torch.core import batch, engine, explorer, heuristics
from repro_torch.core import inefficiency as ineff
from repro_torch.core import simulator, workload
from repro_torch.core.machine import H100_SXM, MI300X, TPU_V5E
from repro_torch.core.machine import machine_for_group
from repro_torch.core.schedule_types import (
    ALL_VARIANTS,
    SIGNATURES,
    STUDIED,
    Schedule,
)
from repro_torch.core.workload import TABLE_I, GemmShape, StepProfile

MACHINES = {"mi300x": MI300X, "tpu_v5e": TPU_V5E, "h100_sxm": H100_SXM}
SCHEDULES = list(Schedule)
# The reference's own pin on the loss decomposition's identity.
SUM_RTOL = 1e-12


def _ref_machine(port):
    """The reference's ``MachineSpec`` with the port machine's fields (the
    reference's DMA-engine budgets, which the core never reads, keep their
    defaults)."""
    kw = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    kw["topology"] = jmachine.Topology(port.topology.value)
    return jmachine.MachineSpec(**kw)


def _ref_gemm(g):
    return jworkload.GemmShape(g.m, g.n, g.k, g.dtype_bytes)


def _ref_schedule(s):
    return JSchedule(s.value)


def _ref_profile(p):
    return jworkload.StepProfile(p.fractions, p.name)


def _ref_scenarios(scenarios):
    names = [s.name.split("/")[0] for s in scenarios]
    by_name = {s.name: s for s in jworkload.TABLE_I}
    return [by_name[n] for n in names]


@pytest.fixture(autouse=True)
def _restore_overrides():
    """``calibrate_tau`` (and ``calibrate_serial_gate(freeze=True)``)
    record per-machine overrides in module state; other tests in the
    process must not see them."""
    saved = [dict(m._TAU_OVERRIDES) for m in (heuristics, jheuristics)]
    gates = [dict(m._SERIAL_GATE_OVERRIDES) for m in (heuristics, jheuristics)]
    yield
    for m, tau, gate in zip((heuristics, jheuristics), saved, gates):
        m._TAU_OVERRIDES.clear()
        m._TAU_OVERRIDES.update(tau)
        m._SERIAL_GATE_OVERRIDES.clear()
        m._SERIAL_GATE_OVERRIDES.update(gate)


def _sim_tuple(r):
    return (r.schedule.value, r.total, r.comm_busy, r.compute_busy,
            r.exposed_comm, r.steps, r.serial_comm, r.serial_gemm)


# ---- the schedule taxonomy -------------------------------------------------

def test_schedule_taxonomy_matches_reference():
    from repro.core import schedule_types as jst

    assert [v.name for v in ALL_VARIANTS] == [v.name for v in jst.ALL_VARIANTS]
    assert [v.concurrency_degree for v in ALL_VARIANTS] == [
        v.concurrency_degree for v in jst.ALL_VARIANTS]
    assert [s.value for s in STUDIED] == [s.value for s in jst.STUDIED]
    assert {s.value: tuple(int(x) for x in lv)
            for s, lv in SIGNATURES.items()} == {
        s.value: tuple(int(x) for x in lv)
        for s, lv in jst.SIGNATURES.items()}
    for s in STUDIED:
        assert s.variant.name == _ref_schedule(s).variant.name


# ---- the simulator ---------------------------------------------------------

@pytest.mark.parametrize("dma,into_place", [(True, False), (False, False),
                                            (True, True)],
                         ids=["dma", "rccl", "into_place"])
@pytest.mark.parametrize("which", sorted(MACHINES))
def test_simulate_matches_reference(which, dma, into_place):
    port_m = MACHINES[which]
    ref_m = _ref_machine(port_m)
    for sc in TABLE_I:
        for s in SCHEDULES:
            got = simulator.simulate(sc.gemm, port_m, s, dma=dma,
                                     dma_into_place=into_place)
            want = jsim.simulate(_ref_gemm(sc.gemm), ref_m, _ref_schedule(s),
                                 dma=dma, dma_into_place=into_place)
            assert _sim_tuple(got) == _sim_tuple(want), (sc.name, s)


@pytest.mark.parametrize("which", sorted(MACHINES))
def test_schedule_steps_and_loss_components_match_reference(which):
    """The step IR field for field; the loss parts equal the reference's
    and sum to the total, with and without the CIL split."""
    port_m = MACHINES[which]
    ref_m = _ref_machine(port_m)
    for sc in TABLE_I:
        for s in SCHEDULES:
            got = simulator.schedule_steps(sc.gemm, port_m, s)
            want = jsim.schedule_steps(_ref_gemm(sc.gemm), ref_m,
                                       _ref_schedule(s))
            for f in dataclasses.fields(got):
                a, b = getattr(got, f.name), getattr(want, f.name)
                if f.name == "schedule":
                    a, b = a.value, b.value
                assert a == b, (sc.name, s, f.name)
            r = got.run()
            assert _sim_tuple(r) == _sim_tuple(simulator.simulate(
                sc.gemm, port_m, s))
            for cil in (None, got.gemm_cil):
                parts = ineff.loss_components(r, gemm_cil=cil)
                assert parts == jineff.loss_components(
                    want.run(), gemm_cil=cil)
                np.testing.assert_allclose(sum(parts.values()), r.total,
                                           rtol=SUM_RTOL)


@pytest.mark.parametrize("which", sorted(MACHINES))
def test_ragged_simulate_matches_reference(which):
    port_m = MACHINES[which]
    ref_m = _ref_machine(port_m)
    profile = StepProfile.zipf(6, 1.2).padded(8)
    ref_profile = _ref_profile(profile)
    for sc in TABLE_I[-4:]:
        for s in SCHEDULES:
            got = simulator.schedule_steps(sc.gemm, port_m, s,
                                           profile=profile)
            want = jsim.schedule_steps(_ref_gemm(sc.gemm), ref_m,
                                       _ref_schedule(s), profile=ref_profile)
            for f in ("comm", "compute"):  # NaN on masked padded steps
                assert np.array_equal(getattr(got, f), getattr(want, f),
                                      equal_nan=True), (sc.name, s, f)
            assert (got.deps, got.comm_active, got.comp_active,
                    got.local_first) == (want.deps, want.comm_active,
                                         want.comp_active, want.local_first)
            assert _sim_tuple(got.run()) == _sim_tuple(want.run())
            parts = ineff.loss_components(got.run())
            assert parts == jineff.loss_components(want.run())
            np.testing.assert_allclose(sum(parts.values()), got.run().total,
                                       rtol=SUM_RTOL)


@pytest.mark.parametrize("which", sorted(MACHINES))
def test_inefficiency_models_match_reference(which):
    port_m = MACHINES[which]
    ref_m = _ref_machine(port_m)
    assert ineff.calibrated_s_half(port_m) == jineff.calibrated_s_half(ref_m)
    s_half = ineff.calibrated_s_half(port_m)
    for sc in TABLE_I:
        g, rg = sc.gemm, _ref_gemm(sc.gemm)
        for acc in (False, True):
            e, re_ = (ineff.gemm_exec(g, port_m, accumulate=acc),
                      jineff.gemm_exec(rg, ref_m, accumulate=acc))
            assert (e.time, e.compute_time, e.memory_time, e.bytes_hbm,
                    e.occupancy, e.splits, e.bound) == (
                re_.time, re_.compute_time, re_.memory_time, re_.bytes_hbm,
                re_.occupancy, re_.splits, re_.bound)
        for axis in ("m", "k"):
            assert ineff.gemm_dil(g, port_m, 8, axis) == jineff.gemm_dil(
                rg, ref_m, 8, axis)
        for degree in (2, 3, 4):
            for dma in (True, False):
                assert ineff.gemm_cil(g, port_m, degree=degree, dma=dma) == \
                    jineff.gemm_cil(rg, ref_m, degree=degree, dma=dma)
                assert ineff.comm_cil(g, port_m, degree=degree, dma=dma) == \
                    jineff.comm_cil(rg, ref_m, degree=degree, dma=dma)
        nbytes = float(g.m * g.k * g.dtype_bytes)
        for fn in ("ag_serial_time", "p2p_step_time", "a2a_chunk_step_time",
                   "hbm_move_time"):
            assert getattr(ineff, fn)(nbytes, port_m) == getattr(jineff, fn)(
                nbytes, ref_m), fn
        assert ineff.comm_time(nbytes, port_m, s_half=s_half,
                               n_transfers=3) == jineff.comm_time(
            nbytes, ref_m, s_half=s_half, n_transfers=3)


def test_best_schedule_at_the_smoke_shape_on_h100():
    """The main path's up/gate projection on a logical group of 4: the
    six predicted times and the pick equal the reference's, and the pick
    is the heuristic's."""
    gemm = GemmShape(2048, 5632, 2048, 2)
    port_m = machine_for_group(H100_SXM, 4)
    best, results = simulator.best_schedule(gemm, port_m)
    ref_best, ref_results = jsim.best_schedule(_ref_gemm(gemm),
                                               _ref_machine(port_m))
    assert best.value == ref_best.value
    assert [_sim_tuple(r) for r in results.values()] == [
        _sim_tuple(r) for r in ref_results.values()]
    assert best is Schedule.SERIAL
    assert heuristics.select_schedule(gemm, port_m).schedule is best


# ---- the grid engines ------------------------------------------------------

_GRID_FIELDS = ("total", "comm_busy", "compute_busy", "exposed", "steps",
                "serial_comm", "serial_gemm", "valid")


def _assert_grids_equal(got, want):
    assert [s.value for s in got.schedules] == [
        s.value for s in want.schedules]
    for f in _GRID_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), f


def _machines():
    return list(MACHINES.values()), [_ref_machine(m)
                                     for m in MACHINES.values()]


@pytest.mark.parametrize("backend", ["scalar", "numpy"])
def test_evaluate_grid_matches_reference(backend):
    port_ms, ref_ms = _machines()
    got = engine.get_engine(backend).evaluate(TABLE_I, port_ms)
    want = jengine.get_engine(backend).evaluate(jworkload.TABLE_I, ref_ms)
    _assert_grids_equal(got, want)
    assert got.valid.any()
    for j, m in enumerate(port_ms):
        for s in (Schedule.SERIAL, Schedule.UNIFORM_FUSED_2D):
            assert got.sim_result(s, 5, j).total == simulator.simulate(
                TABLE_I[5].gemm, m, s).total


@pytest.mark.parametrize("backend", ["scalar", "numpy"])
def test_evaluate_ragged_grid_matches_reference(backend):
    rows = [TABLE_I[i] for i in (1, 5, 13, 14)]
    port = workload.ragged_scenario_grid(steps=4, scenarios=rows)
    ref = jworkload.ragged_scenario_grid(steps=4,
                                         scenarios=_ref_scenarios(rows))
    assert [s.name for s in port] == [s.name for s in ref]
    port_ms, ref_ms = _machines()
    got = engine.get_engine(backend).evaluate(port, port_ms)
    want = jengine.get_engine(backend).evaluate(ref, ref_ms)
    _assert_grids_equal(got, want)
    np.testing.assert_array_equal(got.scenarios.frac, want.scenarios.frac)


def test_port_engines_agree_bit_for_bit():
    """The scalar and the batched engine give the same totals, exposed
    times, step counts, serial references and validity bit for bit.  The
    busy sums differ in the last place, as the reference's do: the scalar
    lowering sums its step tuple with Python's ``sum`` (compensated for
    floats), the batched scan adds step by step."""
    port_ms, _ = _machines()
    for scenarios, fn in ((TABLE_I, batch.evaluate_grid),
                          (workload.ragged_scenario_grid(steps=4),
                           batch.evaluate_ragged_grid)):
        got = fn(scenarios, port_ms)
        want = engine.get_engine("scalar").evaluate(scenarios, port_ms)
        for f in ("total", "exposed", "steps", "serial_comm", "serial_gemm",
                  "valid"):
            assert np.array_equal(getattr(got, f), getattr(want, f),
                                  equal_nan=f in ("total", "exposed")), f
        for f in ("comm_busy", "compute_busy"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=2e-15)


def test_engine_registry_and_unknown_backend():
    # "measured" registers when repro_torch.learn is imported.
    assert set(engine.engine_names()) - {"measured"} == {
        "mixed", "numpy", "scalar", "torch"}
    with pytest.raises(ValueError, match="registered engines: (measured, )?"
                                         "mixed, numpy, scalar, torch"):
        engine.get_engine("jax")
    with pytest.raises(ValueError, match="already registered"):
        engine.register_engine("numpy", engine.NumpyEngine)
    assert isinstance(engine.get_engine("numpy"), engine.Engine)


@pytest.mark.parametrize("backend", ["scalar", "numpy"])
def test_engine_evaluate_is_traced_and_counted(backend, tmp_path):
    """Each evaluation emits the ``engine/evaluate`` span and bumps the
    ``engine/evaluate.{name}`` counter, as the reference's engines do."""
    from repro_torch.obs import metrics, trace

    metrics.reset_metrics()
    trace.enable(str(tmp_path / "t.json"))
    try:
        engine.get_engine(backend).evaluate(TABLE_I[:3], [H100_SXM])
        events = trace.get_tracer().to_json()["traceEvents"]
    finally:
        trace.disable()
    spans = [e for e in events if e.get("name") == "engine/evaluate"]
    assert len(spans) == 1 and spans[0]["args"] == {
        "engine": backend, "n_scenarios": 3}
    counters = metrics.get_metrics().snapshot()["counters"]
    assert counters == {f"engine/evaluate.{backend}": 1}
    metrics.reset_metrics()


@pytest.mark.parametrize("which", sorted(MACHINES))
def test_shortlist_matches_reference(which):
    port_m = MACHINES[which]
    ref_m = _ref_machine(port_m)
    profile = StepProfile.skewed(8, 2.0)
    for sc in TABLE_I[::3]:
        for prof in (None, profile):
            got = engine.shortlist(sc.gemm, port_m, top=6, profile=prof)
            want = jengine.shortlist(
                _ref_gemm(sc.gemm), ref_m, top=6, backend="numpy",
                profile=None if prof is None else _ref_profile(prof))
            assert [(s.value, t) for s, t in got] == [
                (s.value, t) for s, t in want]


# ---- the explorer and the heuristic ----------------------------------------

@pytest.mark.parametrize("backend", ["scalar", "numpy"])
def test_explore_grid_matches_reference(backend):
    port_ms, ref_ms = _machines()
    got = explorer.explore_grid(TABLE_I, machines=port_ms, backend=backend)
    want = jexplorer.explore_grid(jworkload.TABLE_I, machines=ref_ms,
                                  backend=backend)
    assert got.summary() == want.summary()
    assert np.array_equal(got.heuristic_idx, want.heuristic_idx)
    assert np.array_equal(got.heuristic_loss(), want.heuristic_loss(),
                          equal_nan=True)
    ragged = workload.ragged_scenario_grid(steps=4)
    got = explorer.explore_grid(ragged, machines=port_ms, backend=backend)
    want = jexplorer.explore_grid(jworkload.ragged_scenario_grid(steps=4),
                                  machines=ref_ms, backend=backend)
    assert got.summary() == want.summary()
    assert np.array_equal(got.heuristic_idx, want.heuristic_idx)


@pytest.mark.parametrize("which", sorted(MACHINES))
def test_explore_and_prune_report_match_reference(which):
    port_m = MACHINES[which]
    ref_m = _ref_machine(port_m)
    ref_rows = {s.name: s for s in jworkload.TABLE_I}
    for sc in TABLE_I:
        got = explorer.explore(sc, port_m)
        want = jexplorer.explore(ref_rows[sc.name], ref_m)
        assert (got.best.value, got.heuristic.schedule.value,
                got.heuristic_correct, got.heuristic_loss) == (
            want.best.value, want.heuristic.schedule.value,
            want.heuristic_correct, want.heuristic_loss)
        assert explorer.prune_report(sc, port_m) == jexplorer.prune_report(
            ref_rows[sc.name], ref_m)


@pytest.mark.parametrize("which", sorted(MACHINES))
def test_select_schedule_batch_matches_scalar_and_reference(which):
    """Branch for branch: the batched picks equal the scalar tree's on
    every (scenario, group) of a grid that reaches every branch, with the
    gate off and with a skewed profile, and equal the reference's."""
    base = MACHINES[which]
    scenarios = list(TABLE_I) + workload.synthetic_scenarios(24, seed=3) + [
        workload.Scenario("tiny", "SP+TP", "x", GemmShape(256, 512, 256)),
        workload.Scenario("smoke", "SP+TP", "x", GemmShape(2048, 5632, 2048)),
    ]
    sb = batch.ScenarioBatch.from_scenarios(scenarios)
    profile = StepProfile.top_k_hot(8, 2, 0.6)
    seen = set()
    for g in (4, 8, 16):
        port_m = machine_for_group(base, g)
        ref_m = _ref_machine(port_m)
        for kw in (dict(), dict(serial_gate=np.inf), dict(tau=0.2),
                   dict(allow_serial_guard=False)):
            for imb, prof in ((None, None), (profile.imbalance, profile)):
                picks = heuristics.select_schedule_batch(
                    sb.m, sb.n, sb.k, sb.dtype_bytes, port_m,
                    imbalance=imb, **kw)
                want = jheuristics.select_schedule_batch(
                    sb.m, sb.n, sb.k, sb.dtype_bytes, ref_m,
                    imbalance=imb, **kw)
                assert np.array_equal(picks, want)
                for i, sc in enumerate(scenarios):
                    d = heuristics.select_schedule(sc.gemm, port_m,
                                                   profile=prof, **kw)
                    rd = jheuristics.select_schedule(
                        _ref_gemm(sc.gemm), ref_m,
                        profile=None if prof is None else _ref_profile(prof),
                        **kw)
                    assert engine.GRID_SCHEDULES[picks[i]] is d.schedule
                    assert (d.schedule.value, d.metric, d.threshold,
                            d.reason) == (rd.schedule.value, rd.metric,
                                          rd.threshold, rd.reason)
                    seen.add(d.schedule)
        terms = heuristics.serial_gate_terms_batch(
            sb.m, sb.n, sb.k, sb.dtype_bytes, port_m)
        want = jheuristics.serial_gate_terms_batch(
            sb.m, sb.n, sb.k, sb.dtype_bytes, ref_m)
        for a, b in zip(terms, want):
            assert np.array_equal(a, b)
    assert seen >= {Schedule.SERIAL, Schedule.UNIFORM_FUSED_2D}
    assert len(seen) >= 4, seen


@pytest.mark.parametrize("which", sorted(MACHINES))
def test_calibrate_tau_matches_reference(which):
    port_m = MACHINES[which]
    ref_m = _ref_machine(port_m)
    for backend in ("numpy", "scalar"):
        tau = heuristics.calibrate_tau(port_m, TABLE_I, backend=backend)
        assert tau == jheuristics.calibrate_tau(ref_m, jworkload.TABLE_I,
                                                backend=backend)
        assert heuristics.machine_threshold(port_m) == \
            port_m.peak_flops * tau


@pytest.mark.parametrize("synthetic", [0, 16], ids=["table_i",
                                                  "table_i+synthetic"])
def test_calibrate_serial_gate_matches_reference(synthetic):
    port_ms, ref_ms = _machines()
    rows = list(TABLE_I) + workload.synthetic_scenarios(synthetic)
    ref_rows = list(jworkload.TABLE_I) + jworkload.synthetic_scenarios(
        synthetic)
    gate = heuristics.calibrate_serial_gate(port_ms, rows, freeze=True)
    assert gate == jheuristics.calibrate_serial_gate(ref_ms, ref_rows)
    assert all(heuristics.machine_serial_gate(m) == gate for m in port_ms)


# ---- the workload grids ----------------------------------------------------

def test_scenario_grid_matches_reference():
    got = workload.scenario_grid(seqs=(1024, 8192), microbatches=(1, 3))
    want = jworkload.scenario_grid(seqs=(1024, 8192), microbatches=(1, 3))
    assert [(s.name, s.parallelism, s.model, dataclasses.astuple(s.gemm))
            for s in got] == [
        (s.name, s.parallelism, s.model, dataclasses.astuple(s.gemm))
        for s in want]
    assert [(s.name, dataclasses.astuple(s.gemm))
            for s in workload.synthetic_scenarios(16, seed=7)] == [
        (s.name, dataclasses.astuple(s.gemm))
        for s in jworkload.synthetic_scenarios(16, seed=7)]


def test_machine_grid_matches_reference():
    """The port's grid crosses H100_SXM too; the reference's machines come
    out field for field, in the same order."""
    got = workload.machine_grid(groups=(4, 8, 16))
    want = jworkload.machine_grid(groups=(4, 8, 16))
    ref_names = [m.name for m in want]
    port = [m for m in got if not m.name.startswith(H100_SXM.name)]
    assert [m.name for m in port] == ref_names
    for p, r in zip(port, want):
        assert _ref_machine(p) == dataclasses.replace(
            r, dma_sem_slots=128, reg_sem_slots=32, dma_granule=512)
    assert len(got) == len(want) * 3 // 2


@pytest.mark.parametrize("profile", [
    StepProfile.uniform(8),
    StepProfile.skewed(8, 2.0),
    StepProfile.zipf(5, 1.3).padded(8),
    StepProfile.top_k_hot(8, 2, 0.6),
    StepProfile.from_weights([3, 0, 1, 7, 0, 0], name="w"),
], ids=["uniform", "skewed", "zipf-padded", "top2", "weights"])
def test_step_profile_matches_reference(profile):
    ref = _ref_profile(profile)
    assert profile.digest() == ref.digest()
    assert profile.trimmed().digest() == profile.digest()
    for total in (7, 1000, 131072):
        assert profile.quantize(total) == ref.quantize(total)
        assert sum(profile.quantize(total)) == total
    assert (profile.imbalance, profile.active_steps, profile.is_uniform,
            profile.trimmed().fractions) == (
        ref.imbalance, ref.active_steps, ref.is_uniform,
        ref.trimmed().fractions)


def test_tp_gemms_and_geomean_match_reference():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    for arch in ("tinyllama-1.1b", "arctic-480b", "deepseek-v2-lite-16b"):
        got = workload.tp_gemms(get_config(arch), 4096)
        want = jworkload.tp_gemms(jax_get_config(arch), 4096)
        assert {k: dataclasses.astuple(v) for k, v in got.items()} == {
            k: dataclasses.astuple(v) for k, v in want.items()}
    assert workload.tp_token_rows(256, 4096) == jworkload.tp_token_rows(
        256, 4096)
    xs = [1.5, 2.0, 7.25]
    assert workload.geomean(xs) == jworkload.geomean(xs)
