"""The port's grid engine (``repro_torch.autotune.torchgrid``, the
``"torch"`` engine) vs the reference's jax engine and vs the port's
``"numpy"`` engine.

The reference's ``repro.autotune.jaxgrid`` runs in ONE subprocess per
test session (``tests/torch_jax_reference.py``, which aliases
``jax.experimental.enable_x64`` to ``jax.enable_x64`` in that process
only); the port runs here at ``device="cpu"`` on the same seeded inputs.
Values are held at rtol 1e-9, gradients by autograd against ``jax.grad``
at rtol 1e-6.  The torch engine is also held against the port's own
``"numpy"`` engine in process, and the sharded sweep over it against the
unsharded grid.
"""

import numpy as np
import pytest
import torch

import torch_jax_reference as ref_driver
from repro_torch.autotune import torchgrid
from repro_torch.core import TABLE_I
from repro_torch.core.engine import (
    GRID_SCHEDULES,
    TorchEngine,
    engine_names,
    get_engine,
    shortlist,
)
from repro_torch.core.machine import MI300X
from repro_torch.core.workload import GemmShape, machine_grid
from repro_torch.sweep import (
    plan_shards,
    shards_for_host,
    sweep_grid,
    synthetic_batch,
    synthetic_ragged_batch,
)

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

RAW_FIELDS = ("total", "comm_busy", "compute_busy", "exposed", "steps",
              "valid", "serial_comm", "serial_gemm")
RTOL = 1e-9
GRAD_RTOL = 1e-6
MACHINES = machine_grid()[:ref_driver.N_GRID_MACHINES]
CPU = TorchEngine("cpu")


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    """The JAX subprocess runs while the port-only tests above the
    reference's run."""
    ref_driver.start(tmp_path_factory)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return ref_driver.reference(tmp_path_factory)


def _assert_raw_close(got, want, field):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, field
    if got.dtype == bool or field == "steps":
        np.testing.assert_array_equal(got, want, err_msg=field)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), field)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0, err_msg=field)


def _port_dense(requires_grad=False):
    mp = torchgrid.machine_arrays(MACHINES, device="cpu")
    lb = mp.link_bw.clone().requires_grad_(requires_grad)
    sh = mp.s_half.clone().requires_grad_(requires_grad)
    raw = torchgrid.evaluate_grid_raw(
        synthetic_batch(ref_driver.DENSE["n"], seed=ref_driver.DENSE["seed"]),
        mp._replace(link_bw=lb, s_half=sh),
    )
    return raw, lb, sh


_GRID_CASES = {
    "dense": lambda: synthetic_batch(257, seed=3),
    "ragged": lambda: synthetic_ragged_batch(129, seed=4),
    "table_i": lambda: TABLE_I,
}


@pytest.mark.parametrize("dma,into_place", [(True, False), (False, False),
                                            (True, True)],
                         ids=["dma", "rccl", "into_place"])
@pytest.mark.parametrize("case", sorted(_GRID_CASES))
def test_torch_engine_matches_numpy(case, dma, into_place):
    """The registry's ``"torch"`` engine against ``"numpy"`` over the whole
    machine grid (the port's twelve machines, H100_SXM's included)."""
    scenarios = _GRID_CASES[case]()
    machines = machine_grid()
    got = CPU.evaluate(scenarios, machines, dma=dma,
                       dma_into_place=into_place)
    want = get_engine("numpy").evaluate(scenarios, machines, dma=dma,
                                        dma_into_place=into_place)
    assert got.schedules == want.schedules == GRID_SCHEDULES
    for field in ("total", "comm_busy", "compute_busy", "exposed",
                  "serial_comm", "serial_gemm", "valid", "steps"):
        _assert_raw_close(getattr(got, field), getattr(want, field), field)
    np.testing.assert_array_equal(got.best_idx(), want.best_idx())


def test_closed_form_pipeline_equals_the_loop():
    sb = synthetic_batch(200, seed=5)
    loop = torchgrid.evaluate_grid_raw(sb, MACHINES, device="cpu")
    closed = torchgrid.evaluate_grid_raw(sb, MACHINES, closed_form=True,
                                         device="cpu")
    ok = loop[5]
    for i in (0, 1, 2):
        np.testing.assert_allclose(closed[i][ok].numpy(), loop[i][ok].numpy(),
                                   rtol=1e-12, atol=0.0)
    # Exposed time is a difference of two clocks: held relative to total.
    diff = (closed[3] - loop[3])[ok].abs()
    assert bool((diff <= 1e-12 * loop[0][ok]).all())


def test_engine_registry_and_flags():
    assert "torch" in engine_names()
    eng = get_engine("torch")
    assert (eng.name, eng.supports_ragged, eng.differentiable, eng.jit,
            eng.trace_safe) == ("torch", True, True, False, False)
    with pytest.raises(ValueError, match="unknown engine backend 'jax'") as e:
        get_engine("jax")
    assert "torch" in str(e.value)


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        get_engine("torch").evaluate(TABLE_I, [MI300X])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        torchgrid.calibrate_tau(MI300X, [s.gemm for s in TABLE_I])


@pytest.mark.parametrize("case", ["dense", "ragged"])
def test_sweep_gather_on_torch_equals_unsharded(case):
    scenarios = _GRID_CASES[case]()
    machines = machine_grid()[:4]
    res = sweep_grid(scenarios, machines, engine=CPU, num_shards=5)
    whole = CPU.evaluate(scenarios, machines)
    for field in ("total", "exposed", "valid", "serial_comm"):
        np.testing.assert_array_equal(getattr(res.grid, field),
                                      getattr(whole, field))
    assert res.summary()["n_scenarios"] == len(scenarios)


def test_sweep_reduce_on_torch_streams_every_shard():
    seen, grids = [], []
    res = sweep_grid(synthetic_batch(100, seed=6), MACHINES[:2],
                     engine=CPU, num_shards=7, mode="reduce",
                     on_shard=seen.append,
                     on_shard_grid=lambda g, s: grids.append(len(g.scenarios)))
    assert res.grid is None and len(seen) == 7 and sum(grids) == 100
    numpy_res = sweep_grid(synthetic_batch(100, seed=6), MACHINES[:2],
                           num_shards=7, mode="reduce")
    assert res.summary()["best_counts"] == numpy_res.summary()["best_counts"]


def test_sweep_plan_owner_mapping_tiles_the_axis():
    plan = plan_shards(103, 8)
    owned = [shards_for_host(plan, h, 3) for h in range(3)]
    assert sorted(i for o in owned for i in o) == list(range(8))
    assert sum(plan.sizes) == 103


# ---- against the reference's jaxgrid (the session's JAX subprocess) ----

@pytest.mark.parametrize("field", RAW_FIELDS)
def test_dense_grid_matches_jaxgrid(reference, field):
    raw, _, _ = _port_dense()
    i = RAW_FIELDS.index(field)
    _assert_raw_close(raw[i].numpy(), reference["dense"][i], field)


@pytest.mark.parametrize("field", RAW_FIELDS)
def test_ragged_grid_matches_jaxgrid(reference, field):
    machines = machine_grid(groups=ref_driver.RAGGED_GROUPS)[:4]
    raw = torchgrid.evaluate_ragged_grid_raw(
        synthetic_ragged_batch(**ref_driver.RAGGED), machines, device="cpu"
    )
    i = RAW_FIELDS.index(field)
    _assert_raw_close(raw[i].numpy(), reference["ragged"][i], field)


@pytest.mark.parametrize("param", ["link_bw", "s_half"])
def test_grad_matches_jax_grad(reference, param):
    """d sum(valid totals) / d (link_bw, s_half), per machine, by autograd
    against ``jax.grad`` through the reference's engine."""
    raw, lb, sh = _port_dense(requires_grad=True)
    loss = torch.where(raw[5], raw[0], 0.0).sum()
    g_lb, g_sh = torch.autograd.grad(loss, (lb, sh))
    got = {"link_bw": g_lb, "s_half": g_sh}[param].numpy()
    want = reference["dense_grad"][("link_bw", "s_half").index(param)]
    assert np.all(np.isfinite(got)) and np.all(got != 0.0)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=0.0)


def test_calibrate_tau_matches_jaxgrid(reference):
    gemms = [s.gemm for s in TABLE_I]
    tau = torchgrid.calibrate_tau(MI300X, gemms, device="cpu")
    tau_ref = torchgrid.calibrate_tau_reference(MI300X, gemms, device="cpu")
    j_tau, j_ref = reference["tau"]
    assert tau == pytest.approx(j_tau, rel=RTOL)
    assert tau_ref == pytest.approx(j_ref, rel=1e-6)
    # The gradient calibration lands on the bisection reference.
    assert abs(tau / tau_ref - 1.0) < 0.05


@pytest.mark.parametrize("i", range(len(ref_driver.SHORTLIST_GEMMS)))
def test_shortlist_matches_jaxgrid(reference, i):
    gemm = GemmShape(*ref_driver.SHORTLIST_GEMMS[i])
    got = torchgrid.shortlist(gemm, MI300X, top=6, engine=CPU)
    want = reference["shortlist"][i]
    assert [s.value for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([t for _, t in got], [t for _, t in want],
                               rtol=RTOL, atol=0.0)
    assert [s for s, _ in got] == [
        s for s, _ in shortlist(gemm, MI300X, top=6, backend="numpy")]
