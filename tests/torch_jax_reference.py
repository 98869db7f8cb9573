"""The reference's jax grid engine, run once for the port's parity tests.

``repro.autotune`` does not import under jax 0.9.0: ``jaxgrid.py`` imports
``jax.experimental.enable_x64``, which that release dropped while keeping
``jax.enable_x64``.  This script aliases the one to the other in its own
process before importing the reference, and changes nothing under
``src/repro``: the reference's own tests run without the alias and go on
failing as before.

Run as a script (``python tests/torch_jax_reference.py OUT.pkl
ERR.txt``) it evaluates, with ``JAX_PLATFORMS=cpu``:

  * ``dense``: the uniform grid (every raw output) of ``DENSE`` on the
    first ``N_GRID_MACHINES`` of ``machine_grid()``, and ``d sum(valid
    totals) / d (link_bw, s_half)`` by ``jax.grad``;
  * ``ragged``: the ragged grid of ``RAGGED`` on ``machine_grid(groups=
    RAGGED_GROUPS)``;
  * ``tau``: ``calibrate_tau`` and ``calibrate_tau_reference`` on MI300X
    over Table I;
  * ``shortlist``: ``shortlist(backend="jax")`` of ``SHORTLIST_GEMMS``;
  * ``fit``: ``synthesize_records`` from a perturbed MI300X and
    ``fit_machine`` on them (the reference's recovery test);
  * ``moe``: ``serial_a2a_ffn`` and ``ficco_a2a_ffn`` (each case of
    ``MOE_CASES``) under ``shard_map`` on ``MOE["g"]`` devices, on the
    operands :func:`moe_operands` makes.

The script runs with ``MOE["g"]`` forced host devices
(``--xla_force_host_platform_device_count``); the other entries run on
the first, as they would on one.

:func:`start` launches the script once per test session, whatever the
number of pytest-xdist workers (the first caller, under a lock in the
session's shared temporary directory), in the background: the port's
own tests run meanwhile.  :func:`reference` waits for its pickle.
"""

import fcntl
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# Shared by the script and the tests: the same seeds and sizes on both
# sides.  The grids run on the reference's eight machine-grid machines
# (the port's machine_grid()[:8]: MI300X and TPU v5e, groups 8 and 16,
# full mesh and torus), so the padded pipeline runs to g_max 16.
DENSE = dict(n=300, seed=11)
RAGGED = dict(n=200, steps=4, seed=12)
N_GRID_MACHINES = 8
# The ragged grid runs on the group-8 machines (g_max 8: a shorter
# compile); the dense grid covers the padding to 16.
RAGGED_GROUPS = (8,)
FIT_TRUE = {"link_bw_scale": 0.8, "s_half": 3.2e6}
FIT_STEPS = 300
SHORTLIST_GEMMS = ((8192, 4096, 4096, 2), (2048, 5632, 2048, 2),
                   (65536, 8192, 1024, 1))
# The expert-parallel dispatch: g ranks, E global experts, capacity C,
# widths D and F.  C = 12 takes the uniform cuts of 4 (one per rank) and
# of 3, and the explicit sizes below (one empty chunk).
MOE = dict(g=4, e=8, c=12, d=16, f=32, seed=21)
MOE_SIZES = (5, 0, 4, 3)
MOE_SKEW = 2.0  # StepProfile.skewed(g, MOE_SKEW)
MOE_CASES = ("serial", "default", "chunks3", "reverse", "skewed", "sizes")


def moe_operands():
    """x (g, E, C, D), w_up (g, E/g, D, F), w_down (g, E/g, F, D) in
    fp32, rank r's block at [r]: the reference's shard_map blocks of
    (g * E, C, D), (E, D, F) and (E, F, D)."""
    g, e, c, d, f = (MOE[k] for k in "gecdf")
    rng = np.random.default_rng(MOE["seed"])
    x = rng.standard_normal((g, e, c, d)).astype(np.float32)
    w_up = (rng.standard_normal((g, e // g, d, f)) / np.sqrt(d)).astype(
        np.float32)
    w_down = (rng.standard_normal((g, e // g, f, d)) / np.sqrt(f)).astype(
        np.float32)
    return x, w_up, w_down


def main(out_path: str, err_path: str) -> None:
    """Write the results to ``out_path`` (atomically), or the traceback
    to ``err_path``."""
    try:
        out = _evaluate()
        tmp = out_path + ".partial"
        with open(tmp, "wb") as fh:
            pickle.dump(out, fh)
        os.replace(tmp, out_path)
    except BaseException:
        with open(err_path, "w") as fh:
            fh.write(traceback.format_exc())
        raise


def _evaluate() -> dict:
    import jax
    import jax.experimental
    import jax.numpy as jnp

    jax.experimental.enable_x64 = jax.enable_x64
    from repro.autotune import jaxgrid
    from repro.core import TABLE_I, synthetic_scenarios
    from repro.core.machine import MI300X
    from repro.core.schedule_types import Schedule
    from repro.core.workload import GemmShape, machine_grid
    from repro.learn import fit_machine, synthesize_records
    from repro.sweep import synthetic_batch, synthetic_ragged_batch

    machines = machine_grid()[:N_GRID_MACHINES]
    out = {}
    with jax.enable_x64():
        mp = jaxgrid.machine_arrays(machines)
        sb = synthetic_batch(DENSE["n"], seed=DENSE["seed"])

        def total_sum(lb, sh):
            raw = jaxgrid.evaluate_grid_raw(
                sb, mp._replace(link_bw=lb, s_half=sh)
            )
            return jnp.sum(jnp.where(raw[5], raw[0], 0.0)), raw

        (_, raw), grads = jax.value_and_grad(
            total_sum, argnums=(0, 1), has_aux=True
        )(mp.link_bw, mp.s_half)
        out["dense"] = [jax.device_get(a) for a in raw]
        out["dense_grad"] = [jax.device_get(g) for g in grads]
    out["ragged"] = [
        jax.device_get(a) for a in jaxgrid.evaluate_ragged_grid_raw(
            synthetic_ragged_batch(**RAGGED),
            machine_grid(groups=RAGGED_GROUPS),
        )
    ]
    gemms = [s.gemm for s in TABLE_I]
    out["tau"] = (jaxgrid.calibrate_tau(MI300X, gemms),
                  jaxgrid.calibrate_tau_reference(MI300X, gemms))
    out["shortlist"] = [
        [(s.value, t) for s, t in jaxgrid.shortlist(
            GemmShape(*g), MI300X, top=6, backend="jax")]
        for g in SHORTLIST_GEMMS
    ]
    true = {"link_bw": MI300X.link_bw * FIT_TRUE["link_bw_scale"],
            "s_half": FIT_TRUE["s_half"]}
    records = synthesize_records(
        MI300X, [s.gemm for s in synthetic_scenarios(12)],
        (Schedule.SERIAL, Schedule.UNIFORM_FUSED_1D,
         Schedule.HETERO_UNFUSED_1D),
        overrides=true,
    )
    fit = fit_machine(MI300X, records, params=("link_bw", "s_half"),
                      steps=FIT_STEPS)
    out["fit_records"] = [
        ((r.gemm.m, r.gemm.n, r.gemm.k, r.gemm.dtype_bytes),
         r.schedule.value, r.seconds) for r in records
    ]
    out["fit"] = fit.to_payload()
    out["moe"] = _moe_dispatch()
    return out


def _moe_dispatch() -> dict:
    import dataclasses
    import functools

    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.workload import StepProfile
    from repro.overlap.moe import ficco_a2a_ffn, serial_a2a_ffn
    from repro.tune.variants import default_variant

    g = MOE["g"]
    x, w_up, w_down = moe_operands()
    mesh = Mesh(np.array(jax.devices()[:g]), ("ep",))
    spec = P("ep", None, None)
    flat = [a.reshape(-1, *a.shape[2:]) for a in (x, w_up, w_down)]
    reverse = dataclasses.replace(
        default_variant("ficco_a2a_ffn", group=g), dispatch_order="reverse")
    cases = {
        "serial": (serial_a2a_ffn, {}),
        "default": (ficco_a2a_ffn, {}),
        "chunks3": (ficco_a2a_ffn, {"chunks": 3}),
        "reverse": (ficco_a2a_ffn, {"variant": reverse}),
        "skewed": (ficco_a2a_ffn,
                   {"profile": StepProfile.skewed(g, MOE_SKEW)}),
        "sizes": (ficco_a2a_ffn, {"chunk_sizes": MOE_SIZES}),
    }
    out = {}
    for name in MOE_CASES:
        fn, kw = cases[name]
        run = jax.jit(shard_map(
            functools.partial(fn, axis_name="ep", **kw), mesh=mesh,
            in_specs=(spec, spec, spec), out_specs=spec, check_vma=False,
        ))
        out[name] = np.asarray(run(*flat)).reshape(x.shape)
    return out


_LAUNCHED: list = []  # the subprocess this worker started, to be reaped


def _paths(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # shared by every worker of the session
    stem = root / "torch_jax_reference"
    return (stem.with_suffix(".pkl"), stem.with_suffix(".err"),
            stem.with_suffix(".lock"), stem.with_suffix(".started"))


def start(tmp_path_factory) -> None:
    """Launch the script in the background, unless a worker of this
    session already has."""
    out, err, lock, started = _paths(tmp_path_factory)
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        if started.exists():
            return
        started.touch()
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
            "PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={MOE['g']}")
        _LAUNCHED.append(subprocess.Popen(
            [sys.executable, __file__, str(out), str(err)], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        ))


def reference(tmp_path_factory, timeout: float = 600.0) -> dict:
    """The script's results (see the module docstring); raises with the
    script's traceback if it failed."""
    start(tmp_path_factory)
    out, err, _, _ = _paths(tmp_path_factory)
    deadline = time.monotonic() + timeout
    while not out.exists():
        if err.exists():
            raise RuntimeError(err.read_text()[-8000:])
        if time.monotonic() > deadline:
            raise TimeoutError(f"{out} not written within {timeout} s")
        time.sleep(0.1)
    for proc in _LAUNCHED:
        proc.wait(timeout=60)
    with open(out, "rb") as fh:
        return pickle.load(fh)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
