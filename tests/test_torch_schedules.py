"""The port's six schedules, ``ficco_linear`` and the schedule heuristic vs
the reference.

The reference's schedules (``repro.overlap``) run in ONE subprocess on 4
forced host devices under ``shard_map`` and write their results to an
``.npz``; the port runs here on the CPU, over the same numpy-seeded inputs,
with its logical ranks stacked on a leading dim.  Shapes and tolerances are
those of ``tests/multidev_driver.py`` (1e-5 f32, 2e-2 bf16).  Run as a
script (``python tests/test_torch_schedules.py OUT.npz``) the file is that
subprocess.  The heuristic is compared in process: ``repro.core`` imports
no JAX.
"""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import heuristics, linkmodel
from repro_torch.core.machine import H100_SXM, MI300X, TPU_V5E
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import GemmShape
from repro_torch.kernels import ops
from repro_torch.overlap.api import ficco_linear, resolve_schedule
from repro_torch.overlap.schedules import SCHEDULE_FNS, run_schedule
from repro_torch.parallel.sharding import shard_columns, shard_rows

_ROOT = Path(__file__).resolve().parents[1]
G = 4
SHAPES = [(128, 64, 64), (256, 128, 128), (512, 256, 64)]  # (m, n, k)
DTYPES = ("float32", "bfloat16")
LINEAR_SCHEDULES = (
    "auto", "serial", "uniform-fused-1d", "hetero-fused-1d",
    "uniform-fused-2d",
)


def _tol(dtype):
    return (
        dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
        else dict(rtol=1e-5, atol=1e-5)
    )


def _schedule_inputs(m, n, k):
    rng = np.random.default_rng(m + 10 * n + 100 * k)
    return (
        rng.standard_normal((m, k)).astype(np.float32),
        rng.standard_normal((k, n)).astype(np.float32),
    )


def _linear_inputs():
    rng = np.random.default_rng(1)
    return (
        rng.standard_normal((256, 128)).astype(np.float32),
        rng.standard_normal((128, 128)).astype(np.float32),
    )


def _indivisible_inputs():
    """8*9 rows: 18 per rank, not divisible by 4 chunks -> serial."""
    rng = np.random.default_rng(2)
    return (
        rng.standard_normal((8 * 9, 64)).astype(np.float32),
        rng.standard_normal((64, 64)).astype(np.float32),
    )


def _reference_main(out_path):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={G} "
        + os.environ.get("XLA_FLAGS", "")
    )
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.schedule_types import Schedule as JaxSchedule
    from repro.overlap.api import ficco_linear as jax_ficco_linear
    from repro.overlap.schedules import run_schedule as jax_run_schedule

    mesh = jax.make_mesh((G,), ("tp",))

    def sharded(fns, x, w):
        """Every fn of ``fns`` on (x, w) in one jitted shard_map."""
        outs = jax.jit(shard_map(
            lambda xs, ws: tuple(fn(xs, ws) for fn in fns), mesh=mesh,
            in_specs=(P("tp", None), P(None, "tp")),
            out_specs=tuple(P(None, "tp") for _ in fns), check_vma=False,
        ))(x, w)
        return [np.asarray(o).astype(np.float32) for o in outs]

    results = {}
    for (m, n, k), dtype in itertools.product(SHAPES, DTYPES):
        x, w = (jnp.asarray(a, getattr(jnp, dtype))
                for a in _schedule_inputs(m, n, k))
        outs = sharded([
            functools.partial(jax_run_schedule, sched, axis_name="tp")
            for sched in JaxSchedule
        ], x, w)
        for sched, out in zip(JaxSchedule, outs):
            results[f"{sched.value}_{m}x{n}x{k}_{dtype}"] = out
    outs = sharded([
        functools.partial(jax_ficco_linear, axis_name="tp", schedule=sched)
        for sched in LINEAR_SCHEDULES
    ], *_linear_inputs())
    for schedule, out in zip(LINEAR_SCHEDULES, outs):
        results[f"linear_{schedule}"] = out
    [results["indivisible"]] = sharded([functools.partial(
        jax_ficco_linear, axis_name="tp", schedule="uniform-fused-1d"
    )], *_indivisible_inputs())
    np.savez(out_path, **results)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("schedules_ref") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", ""
    )
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, __file__, str(out)],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-8000:]
    with np.load(out) as data:
        return dict(data)


def _port_args(x, w, dtype="float32"):
    tdt = getattr(torch, dtype)
    return (
        shard_rows(torch.from_numpy(x).to(tdt), G),
        shard_columns(torch.from_numpy(w).to(tdt), G),
    )


def _global(out):
    """(G, M, n_local) rank blocks -> the global (M, G*n_local) product."""
    g, m, n_local = out.shape
    return out.permute(1, 0, 2).reshape(m, g * n_local).float().numpy()


@pytest.mark.parametrize("sched", list(Schedule), ids=lambda s: s.value)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_schedule_matches_reference(reference, sched, dtype, shape):
    m, n, k = shape
    x, w = _port_args(*_schedule_inputs(m, n, k), dtype)
    got = run_schedule(sched, x, w)
    assert got.dtype == x.dtype and got.shape == (G, m, n // G)
    want = reference[f"{sched.value}_{m}x{n}x{k}_{dtype}"]
    np.testing.assert_allclose(_global(got), want, **_tol(dtype))


@pytest.mark.parametrize("schedule", LINEAR_SCHEDULES)
def test_ficco_linear_matches_reference(reference, schedule):
    x, w = _linear_inputs()
    got = ficco_linear(*_port_args(x, w), schedule=schedule)
    np.testing.assert_allclose(
        _global(got), reference[f"linear_{schedule}"], **_tol("float32")
    )
    np.testing.assert_allclose(_global(got), x @ w, **_tol("float32"))


def test_indivisible_shape_falls_back_to_serial(reference):
    x, w = _indivisible_inputs()
    got = ficco_linear(*_port_args(x, w), schedule="uniform-fused-1d")
    np.testing.assert_allclose(
        _global(got), reference["indivisible"], **_tol("float32")
    )
    with pytest.raises(ValueError):
        SCHEDULE_FNS[Schedule.UNIFORM_FUSED_1D](*_port_args(x, w))


def test_schedules_agree_with_serial_on_every_rank():
    """Every schedule gives every rank the serial schedule's block, here
    with more ranks than the reference run (8) and a non-square shard."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((8, 64, 96)).astype(np.float32))
    w_full = rng.standard_normal((96, 8 * 24)).astype(np.float32)
    w = shard_columns(torch.from_numpy(w_full), 8)
    want = torch.from_numpy(x.reshape(512, 96).numpy() @ w_full)
    for sched in Schedule:
        got = run_schedule(sched, x, w)
        for r in range(8):
            torch.testing.assert_close(
                got[r], want[:, r * 24:(r + 1) * 24], rtol=1e-5, atol=1e-5,
                msg=f"{sched.value} rank {r}",
            )


def test_2d_schedule_accumulates_through_k2(monkeypatch):
    """Each of the g steps folds its panel into one fp32 accumulator via
    ops.matmul_accumulate; bf16 operands are summed in fp32 throughout."""
    calls = []
    orig = ops.matmul_accumulate

    def spy(c, x, w):
        calls.append((c.dtype, x.dtype, tuple(x.shape), tuple(w.shape)))
        return orig(c, x, w)

    monkeypatch.setattr(ops, "matmul_accumulate", spy)
    x, w = _port_args(*_schedule_inputs(128, 64, 64), "bfloat16")
    got = run_schedule(Schedule.UNIFORM_FUSED_2D, x, w)
    assert calls == [
        (torch.float32, torch.bfloat16, (G, 128, 16), (G, 16, 16))
    ] * G
    want = torch.matmul(
        x.reshape(128, 64).float(), w.float()
    ).to(torch.bfloat16)
    torch.testing.assert_close(got, want, **_tol("bfloat16"))


def test_autotune_raises_naming_the_roadmap():
    x, w = _port_args(*_linear_inputs())
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        ficco_linear(x, w, schedule="autotune")


# ---------------------------------------------------------------------------
# The heuristic, in process against repro.core (which imports no JAX)
# ---------------------------------------------------------------------------

_GRID = list(itertools.product(
    (256, 1024, 2048, 8192, 131072),  # m
    (512, 5632, 16384),  # n
    (128, 2048, 8192, 131072),  # k
    (2, 4),  # dtype bytes
    (2, 4, 8, 16),  # group
)) + [(2048, 5632, 2048, 2, 4)]  # the smoke path's up/gate projection


def _machines():
    from repro.core import machine as jm

    return [(TPU_V5E, jm.TPU_V5E), (MI300X, jm.MI300X)]


@pytest.mark.parametrize("which", ["tpu", "mi300x"])
def test_select_schedule_matches_reference(which):
    from repro.core import heuristics as jh
    from repro.core.machine import machine_for_group as jax_for_group
    from repro.core.workload import GemmShape as JaxGemmShape

    port_m, ref_m = _machines()[["tpu", "mi300x"].index(which)]
    from repro_torch.core.machine import machine_for_group

    picked = set()
    for m, n, k, b, g in _GRID:
        pm, rm = machine_for_group(port_m, g), jax_for_group(ref_m, g)
        got = heuristics.select_schedule(GemmShape(m, n, k, b), pm)
        want = jh.select_schedule(
            JaxGemmShape(m, n, k, b), rm,
            tau=jh.DEFAULT_TAU, serial_gate=jh.DEFAULT_SERIAL_GATE,
        )
        assert got.schedule.value == want.schedule.value, (m, n, k, b, g)
        assert (got.metric, got.threshold, got.reason) == (
            want.metric, want.threshold, want.reason
        )
        np.testing.assert_allclose(
            heuristics.serial_gate_score(GemmShape(m, n, k, b), pm),
            jh.serial_gate_score(JaxGemmShape(m, n, k, b), rm),
            rtol=1e-12,
        )
        picked.add(got.schedule)
    assert len(picked) >= 3, picked  # the grid reaches several branches


@pytest.mark.parametrize("which", ["tpu", "mi300x"])
def test_resolve_schedule_matches_reference(which):
    from repro.overlap.api import resolve_schedule as jax_resolve

    port_m, ref_m = _machines()[["tpu", "mi300x"].index(which)]
    for m, n, k, b, g in _GRID:
        for schedule in ("auto", "hetero-fused-1d"):
            got = resolve_schedule(schedule, m=m, n=n, k=k, machine=port_m,
                                   dtype_bytes=b, group=g)
            want = jax_resolve(schedule, m=m, n=n, k=k, machine=ref_m,
                               dtype_bytes=b, group=g)
            assert got.value == want.value, (schedule, m, n, k, b, g)


def test_constants_and_s_half_match_reference():
    from repro.core import heuristics as jh
    from repro.core.inefficiency import calibrated_s_half as jax_s_half

    for name in ("DEFAULT_TAU", "MIN_DECOMPOSE_FLOPS", "DEFAULT_SERIAL_GATE",
                 "_GATE_COMM_CIL"):
        assert getattr(heuristics, name) == getattr(jh, name), name
    for port_m, ref_m in _machines():
        np.testing.assert_allclose(
            linkmodel.calibrated_s_half(port_m), jax_s_half(ref_m),
            rtol=1e-12,
        )


def test_machine_specs_match_reference():
    import dataclasses

    from repro.core import machine as jm
    from repro_torch.core.machine import get_machine, machine_for_group

    for port_m, ref_m in _machines():
        for field in dataclasses.fields(port_m):
            got, want = getattr(port_m, field.name), getattr(ref_m, field.name)
            if field.name == "topology":
                got, want = got.value, want.value
            assert got == want, (port_m.name, field.name)
        assert get_machine(port_m.name) is port_m
        for g in (2, 4, 8):
            assert machine_for_group(port_m, g).a2a_links == (
                jm.machine_for_group(ref_m, g).a2a_links
            )
            assert machine_for_group(port_m, g).ag_bw == (
                jm.machine_for_group(ref_m, g).ag_bw
            )
    h100 = get_machine("h100-sxm-8")
    assert (h100.topology.value, h100.a2a_links, h100.ag_bw) == (
        "switch", 1, 450e9
    )
    assert machine_for_group(h100, 4).a2a_links == 1  # switch ports stay


def test_auto_resolves_serial_at_the_smoke_shape_on_h100():
    """The smoke path's projection is comm-bound on every machine spec
    (gate score far above 1.2), so the card runs the other schedules only
    by name."""
    from repro_torch.core.machine import machine_for_group

    gemm = GemmShape(2048, 5632, 2048, 2)
    h100 = machine_for_group(H100_SXM, G)
    assert heuristics.serial_gate_score(gemm, h100) > 10.0
    assert resolve_schedule("auto", m=2048, n=5632, k=2048,
                            group=G) is Schedule.SERIAL


if __name__ == "__main__":
    _reference_main(sys.argv[1])
