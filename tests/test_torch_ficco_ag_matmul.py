"""The port's K4 ``ficco_ag_matmul_fused`` (plain version on the CPU) vs the
reference's oracle.

The reference kernel blocks in the Mosaic interpreter on this tree's jax,
so its own oracle ``repro.kernels.ref.ag_matmul_ref`` (all-gather, then one
GEMM) is the reference here, run under ``shard_map`` in ONE subprocess on 4
forced host devices at ``tests/multidev_kernels_driver.py``'s shapes; its
results come back in an ``.npz``.  Run as a script (``python
tests/test_torch_ficco_ag_matmul.py OUT.npz``) the file is that subprocess.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.schedule_types import Schedule
from repro_torch.kernels import ops
from repro_torch.kernels.ficco_ag_matmul import _plan, ficco_ag_matmul_fused
from repro_torch.overlap.schedules import run_schedule
from repro_torch.tune.variants import default_variant

_ROOT = Path(__file__).resolve().parents[1]
G = 4
# Per-rank shard (m_s, K, n_local) and dtype: multidev_kernels_driver.py's.
CASES = [(64, 128, 128, "float32"), (32, 256, 128, "bfloat16")]


def _tol(dtype):
    return (
        dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
        else dict(rtol=1e-5, atol=1e-5)
    )


def _inputs(m_s, k, n_local):
    rng = np.random.default_rng(2 + m_s)
    return (
        rng.standard_normal((G * m_s, k)).astype(np.float32),
        rng.standard_normal((k, G * n_local)).astype(np.float32),
    )


def _reference_main(out_path):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={G} "
        + os.environ.get("XLA_FLAGS", "")
    )
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.kernels import ref

    mesh = jax.make_mesh((G,), ("tp",))
    results = {}
    for m_s, k, n_local, dtype in CASES:
        x, w = (jnp.asarray(a, getattr(jnp, dtype))
                for a in _inputs(m_s, k, n_local))
        fn = shard_map(
            lambda xs, ws: ref.ag_matmul_ref(xs, ws, axis_name="tp"),
            mesh=mesh, in_specs=(P("tp", None), P(None, "tp")),
            out_specs=P(None, "tp"), check_vma=False,
        )
        results[f"{m_s}x{k}x{n_local}_{dtype}"] = np.asarray(
            jax.jit(fn)(x, w)
        ).astype(np.float32)
    np.savez(out_path, **results)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ag_ref") / "ref.npz"
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


def _stacked(x, w, dtype):
    tdt = getattr(torch, dtype)
    k, n = w.shape
    return (
        torch.from_numpy(x).to(tdt).view(G, -1, k),
        torch.from_numpy(w).to(tdt).view(k, G, n // G).permute(1, 0, 2),
    )


def _variants():
    base = default_variant("ficco_ag_matmul", group=G)
    return {
        "default": base,
        "c2": dataclasses.replace(base, chunks=2),
        "c4_d3": dataclasses.replace(base, chunks=4, buffer_depth=3),
        "d3": dataclasses.replace(base, buffer_depth=3),
        "reverse": dataclasses.replace(base, dispatch_order="reverse"),
        "c3_fallback": dataclasses.replace(base, chunks=3),
    }


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}"
                         f"_{c[3]}")
def test_fused_matches_reference_oracle(reference, case):
    m_s, k, n_local, dtype = case
    x, w = _stacked(*_inputs(m_s, k, n_local), dtype)
    got = ficco_ag_matmul_fused(x, w)
    assert got.dtype == x.dtype and got.shape == (G, G * m_s, n_local)
    global_out = got.permute(1, 0, 2).reshape(G * m_s, G * n_local)
    np.testing.assert_allclose(
        global_out.float().numpy(),
        reference[f"{m_s}x{k}x{n_local}_{dtype}"], **_tol(dtype),
    )


# (steps, buffer depth, reverse) each variant launches with at m_s = 64.
_PLANS = {
    "default": (4, 2, False), "c2": (2, 2, False), "c4_d3": (4, 3, False),
    "d3": (4, 3, False), "reverse": (4, 2, True),
    "c3_fallback": (4, 2, False),  # 3 does not divide 64: one chunk a rank
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_variants_bit_equal_to_each_other_and_serial(dtype):
    """Each variant is planned as the reference plans it (the chunks=3
    fallback included) and, here on the plain version, gives the serial
    schedule's bits.  That the kernel's variants give identical bits is
    checked on the card by chip_smoke.py's kernels phase."""
    x, w = _stacked(*_inputs(64, 128, 128), dtype)
    want = run_schedule(Schedule.SERIAL, x, w)
    for name, v in _variants().items():
        assert _plan(v, G, 64) == _PLANS[name], name
        got = ficco_ag_matmul_fused(x, w, variant=v)
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)


def test_indivisible_variant_raises():
    """5 rows per rank cut neither into 2 chunks nor, falling back, into 4."""
    x, w = _stacked(*_inputs(5, 16, 8), "float32")
    with pytest.raises(ValueError, match="not divisible"):
        ficco_ag_matmul_fused(x, w, variant=_variants()["c2"])


def test_ops_wrapper_plain_on_cpu_counts_no_launch():
    x, w = _stacked(*_inputs(32, 64, 32), "float32")
    ops.reset_launch_counts()
    got = ops.ag_matmul_fused(x, w)
    assert ops.launch_counts()["ficco_ag_matmul_fused"] == 0
    torch.testing.assert_close(
        got, torch.matmul(x.reshape(G * 32, 64), w), rtol=0, atol=0
    )


if __name__ == "__main__":
    _reference_main(sys.argv[1])
