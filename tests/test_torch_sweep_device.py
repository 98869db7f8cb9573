"""The port's card-resident sweep (``repro_torch.sweep.device``): the
counter-based synthesis against the reference's numpy host twins, the
``"mixed"`` engine against the ``"torch"`` engine, the fused
synthesis + grid + GateStats sweep against the reference's numpy-engine
``sweep_stats``, the runner's ``overlap_dispatch`` and
``device_parallel``, the on-card merge, and the two command lines.

Every oracle runs in this process without JAX: the reference's host
twins and its numpy engine import none.  The port runs at
``device="cpu"``.  Tolerances are the reference's
(``tests/test_device_sweep.py``): integers and masks exact, fractions
within 1e-14, float64 bit for bit, float32 within rtol 1e-4 and bfloat16
within rtol 5e-2 / atol 1e-4 of float64.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from grid_asserts import assert_grid_identical
from repro.core import workload as jworkload
from repro.learn import stats as jstats
from repro.sweep import device as jdevice
from repro_torch.core import TABLE_I
from repro_torch.core.batch import ScenarioBatch
from repro_torch.core.engine import (
    MixedEngine,
    TorchEngine,
    engine_names,
    get_engine,
)
from repro_torch.core.workload import GemmShape, machine_grid
from repro_torch.learn.stats import GateStats, sweep_stats
from repro_torch.sweep import (
    device,
    device_batch,
    device_merge_stats,
    device_ragged_batch,
    host_batch,
    host_ragged_batch,
    sweep_device_stats,
    sweep_grid,
    synthetic_batch,
    synthetic_ragged_batch,
)

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

CPU = "cpu"
# The reference's machine_grid(groups=(8,)) is the port's first four
# (the port's adds H100_SXM's two).
MACHINES = machine_grid(groups=(8,))[:4]
J_MACHINES = jworkload.machine_grid(groups=(8,))
ALL = machine_grid(groups=(8,))
RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
ATOL = {"float32": 0.0, "bfloat16": 1e-4}
FIELDS = ("m", "n", "k", "dtype_bytes")
# The engine suite's degenerate zoo (indivisible / zero-row shapes).
ZOO = [
    GemmShape(8192, 57344, 8192),
    GemmShape(1001, 4096, 4096),
    GemmShape(32, 4096, 4096),
    GemmShape(8192, 8192, 8191),
]


def _zoo_batch() -> ScenarioBatch:
    return ScenarioBatch.from_gemms(ZOO + [s.gemm for s in TABLE_I])


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


# ---- synthesis ---------------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_synthesis_matches_reference_host_twins(ragged):
    if ragged:
        want = jdevice.host_ragged_batch(256, seed=4)
        got = (device_ragged_batch(256, seed=4, device=CPU),
               host_ragged_batch(256, seed=4))
    else:
        want = jdevice.host_batch(512, seed=9)
        got = (device_batch(512, seed=9, device=CPU), host_batch(512, seed=9))
    for batch in got:
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(batch, f),
                                          getattr(want, f), f)
        if ragged:
            np.testing.assert_array_equal(batch.frac == 0.0, want.frac == 0.0)
            np.testing.assert_allclose(batch.frac, want.frac, rtol=0,
                                       atol=1e-14)
    if ragged:  # the host twin is the reference's arithmetic verbatim
        np.testing.assert_array_equal(got[1].frac, want.frac)


def test_synthesis_shards_compose_and_decorrelate():
    full, part = device_batch(96, seed=2, device=CPU), device_batch(
        32, seed=2, start=48, device=CPU)
    hpart = host_batch(32, seed=2, start=48)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(full, f)[48:80],
                                      getattr(part, f))
        np.testing.assert_array_equal(getattr(hpart, f), getattr(part, f))
    rfull = device_ragged_batch(64, seed=2, device=CPU)
    rpart = device_ragged_batch(16, seed=2, start=24, device=CPU)
    np.testing.assert_array_equal(rfull.frac[24:40], rpart.frac)
    a, b = host_batch(256, seed=0), host_batch(256, seed=1)
    assert not np.array_equal(a.m, b.m)
    assert not np.array_equal(a.m, a.k)


@pytest.mark.parametrize("x", [0, 2**63 - 1, 2**63, 2**64 - 1],
                         ids=["0", "2^63-1", "2^63", "2^64-1"])
def test_int64_splitmix_matches_reference_at_the_edges(x):
    t = torch.tensor([device._i64(x)], dtype=torch.int64)
    assert int(device._mix64(t)[0]) & device._MASK64 == jdevice._mix64_int(x)
    assert device._mix64_int(x) == jdevice._mix64_int(x)
    assert device._field_key(x, 7) == jdevice._field_key(x, 7)


# ---- the mixed engine --------------------------------------------------------

def test_mixed_engine_registered_with_flags_and_checks_dtype():
    assert "mixed" in engine_names()
    eng = get_engine("mixed")
    assert (eng.name, eng.dtype, eng.supports_ragged, eng.jit,
            eng.differentiable, eng.trace_safe) == (
        "mixed", "float32", True, False, False, False)
    with pytest.raises(ValueError, match="float16"):
        MixedEngine(dtype="float16")
    with pytest.raises(ValueError, match="float16"):
        sweep_device_stats(8, MACHINES, dtype="float16", device=CPU)


@pytest.mark.parametrize("ragged", [False, True], ids=["zoo", "ragged"])
def test_mixed_float64_bit_identical_to_torch_engine(ragged):
    batch = (device_ragged_batch(48, seed=5, device=CPU) if ragged
             else _zoo_batch())
    want = TorchEngine(CPU).evaluate(batch, ALL)
    assert_grid_identical(
        MixedEngine("float64", device=CPU).evaluate(batch, ALL), want)


@pytest.mark.parametrize("ragged", [False, True], ids=["zoo", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_reduced_precision_within_tolerance(dtype, ragged):
    batch = (device_ragged_batch(48, seed=5, device=CPU) if ragged
             else _zoo_batch())
    want = TorchEngine(CPU).evaluate(batch, ALL)
    got = MixedEngine(dtype, device=CPU).evaluate(batch, ALL)
    # Valid masks are integer logic: equal at any dtype.
    np.testing.assert_array_equal(got.valid, want.valid)
    a, b = got.total[got.valid], want.total[want.valid]
    np.testing.assert_allclose(a, b, rtol=RTOL[dtype], atol=ATOL[dtype])
    if not ragged:
        np.testing.assert_allclose(
            got.exposed[got.valid], want.exposed[want.valid],
            rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(b).max())


# ---- the fused sweep ---------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_fused_float64_equals_reference_numpy_sweep_stats(ragged):
    """Synthesis + grid + statistics in float64 give the reference's
    host pipeline's histogram and tallies on the same lanes."""
    S, seed = (512, 6) if ragged else (1024, 3)
    got, gres = sweep_device_stats(S, MACHINES, seed=seed, dtype="float64",
                                   num_shards=2, ragged=ragged, device=CPU)
    lanes = (jdevice.host_ragged_batch if ragged else jdevice.host_batch)(
        S, seed=seed)
    want, wres = jstats.sweep_stats(lanes, J_MACHINES, backend="numpy",
                                    num_shards=2)
    np.testing.assert_array_equal(got.hist, want.hist)
    assert got.n_points == want.n_points == S * len(MACHINES)
    assert got.best_counts == want.best_counts
    assert [s.best_counts for s in gres.summaries] == [
        _nonzero(s.best_counts) for s in wres.summaries]
    np.testing.assert_allclose(got.moments, want.moments, rtol=1e-12)


def test_fused_float32_equals_stats_of_its_own_grid():
    got, _ = sweep_device_stats(1024, ALL, seed=3, dtype="float32",
                                device=CPU)
    grid = MixedEngine("float32", device=CPU).evaluate(
        device_batch(1024, seed=3, device=CPU), ALL)
    want = GateStats.from_grid(grid)
    np.testing.assert_array_equal(got.hist, want.hist)
    assert got.best_counts == want.best_counts


def test_fused_per_family_partitions_the_global_stats():
    fams, _ = sweep_device_stats(1024, ALL, seed=3, per_family=True,
                                 device=CPU)
    glob, _ = sweep_device_stats(1024, ALL, seed=3, device=CPU)
    assert set(fams) == {"mi300x-8", "tpu-v5e-axis16", "h100-sxm-8"}
    summed = functools.reduce(GateStats.merge, fams.values())
    np.testing.assert_array_equal(summed.hist, glob.hist)
    assert summed.n_points == glob.n_points
    assert summed.best_counts == glob.best_counts


def test_fused_overlap_dispatch_changes_nothing_and_stats_can_be_off():
    runs = [sweep_device_stats(1024, MACHINES, seed=3, num_shards=4,
                               overlap_dispatch=flag, device=CPU)
            for flag in (True, False)]
    (on, ron), (off, roff) = runs
    np.testing.assert_array_equal(on.hist, off.hist)
    assert on.best_counts == off.best_counts
    assert [(s.shard, s.best_counts) for s in ron.summaries] == [
        (s.shard, s.best_counts) for s in roff.summaries]
    stats, res = sweep_device_stats(1024, MACHINES, seed=3,
                                    collect_stats=False, device=CPU)
    assert stats is None
    assert sum(s.n_scenarios for s in res.summaries) == 1024
    assert res.summary()["best_counts"] == on.best_counts


# ---- the runner --------------------------------------------------------------

def _stable(summary) -> dict:
    d = summary.to_json()
    d.pop("seconds"), d.pop("scenarios_per_sec")
    return d


def test_runner_overlap_flag_is_inert_on_numpy():
    sb = synthetic_batch(300, seed=1)
    on = sweep_grid(sb, MACHINES, num_shards=5, overlap_dispatch=True)
    off = sweep_grid(sb, MACHINES, num_shards=5)
    assert_grid_identical(on.grid, off.grid)
    assert list(map(_stable, on.summaries)) == list(map(_stable,
                                                        off.summaries))


def test_runner_mixed_two_phase_identical_to_eager():
    sb = device_batch(512, seed=7, device=CPU)
    eng = MixedEngine("float32", device=CPU)
    on = sweep_grid(sb, ALL, engine=eng, num_shards=4, overlap_dispatch=True)
    off = sweep_grid(sb, ALL, engine=eng, num_shards=4)
    assert_grid_identical(on.grid, off.grid)
    assert list(map(_stable, on.summaries)) == list(map(_stable,
                                                        off.summaries))


def test_runner_empty_shards_keep_summary_order():
    res = sweep_grid(device_batch(3, seed=0, device=CPU), MACHINES,
                     engine=MixedEngine(device=CPU), num_shards=6,
                     mode="reduce", overlap_dispatch=True)
    assert [s.shard for s in res.summaries] == list(range(6))
    assert sum(s.n_scenarios for s in res.summaries) == 3


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_runner_device_parallel_identical_to_unsharded(ragged):
    sb = (synthetic_ragged_batch(77, seed=2) if ragged
          else synthetic_batch(101, seed=1))
    want = sweep_grid(sb, ALL, engine=TorchEngine(CPU), num_shards=3)
    got = sweep_grid(sb, ALL, device_parallel=True, devices=[CPU, CPU],
                     num_shards=3)
    assert_grid_identical(got.grid, want.grid)
    assert list(map(_stable, got.summaries)) == list(map(_stable,
                                                         want.summaries))


# ---- the merge ---------------------------------------------------------------

@pytest.fixture(scope="module")
def stats_list():
    return [sweep_stats(synthetic_ragged_batch(60, seed=40 + i), MACHINES[:2],
                        num_shards=2)[0] for i in range(3)]


def test_device_merge_bit_identical_to_host_fold(stats_list):
    got = device_merge_stats(stats_list, device=CPU)
    want = functools.reduce(GateStats.merge, stats_list)
    np.testing.assert_array_equal(got.hist, want.hist)
    np.testing.assert_array_equal(got.moments, want.moments)
    assert (got.best_counts, got.n_points, got.schema) == (
        want.best_counts, want.n_points, want.schema)


def test_device_merge_one_and_no_input_and_schema(stats_list):
    only = device_merge_stats(stats_list[:1], device=CPU)
    np.testing.assert_array_equal(only.hist, stats_list[0].hist)
    assert only.n_points == stats_list[0].n_points
    empty = device_merge_stats([], device=CPU)
    assert empty.n_points == 0
    np.testing.assert_array_equal(empty.hist, GateStats.empty().hist)
    bad = dataclasses.replace(stats_list[1], schema=stats_list[1].schema + 1)
    with pytest.raises(ValueError, match="schema"):
        device_merge_stats([stats_list[0], bad], device=CPU)


# ---- the command lines -------------------------------------------------------

def test_sweep_cli_mixed_dtype_and_synth_device(tmp_path, capsys):
    """The sweep CLI drives the mixed engine end to end on --device cpu
    (one subprocess); --dtype without --backend mixed is a usage error;
    merge_sweep reads the stream and refuses mixed dtypes."""
    from repro_torch.scripts import merge_sweep, sweep

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = tmp_path / "sweep.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.scripts.sweep",
         "--scenarios", "64", "--shards", "2", "--mode", "reduce",
         "--backend", "mixed", "--dtype", "float32", "--synth-device",
         "--overlap-dispatch", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    host = [json.loads(ln)["host_summary"]
            for ln in out.read_text().splitlines() if "host_summary" in ln]
    assert len(host) == 1
    assert (host[0]["dtype"], host[0]["synth"], host[0]["n_scenarios"],
            host[0]["plan_shards"]) == ("float32", "device", 64, 2)

    with pytest.raises(SystemExit) as exc:
        sweep.main(["--scenarios", "8", "--dtype", "bfloat16"])
    assert exc.value.code == 2
    assert "requires --backend mixed" in capsys.readouterr().err

    merged = tmp_path / "merged.json"
    merge_sweep.main([str(out), "--out", str(merged), "--strict"])
    got = json.loads(merged.read_text())
    assert (got["complete"], got["n_scenarios"], got["dtype"]) == (
        True, 64, "float32")
    other = tmp_path / "f64.jsonl"
    other.write_text(json.dumps({"host_summary": dict(host[0],
                                                      dtype="float64")})
                     + "\n")
    with pytest.raises(SystemExit) as exc:
        merge_sweep.main([str(out), str(other)])
    assert exc.value.code == 4
    assert "mismatched dtypes" in capsys.readouterr().err
