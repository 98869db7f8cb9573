"""The port's chunk exchange and uniform-fused-1D composer vs the reference.

The reference (``repro.kernels.dma_exchange``) runs in ONE subprocess on 4
forced host devices, its Pallas kernels in interpret mode, and writes its
results to an ``.npz``; the port runs here on the CPU, over the same
numpy-seeded inputs, with its logical ranks stacked on a leading dim.
Run as a script (``python tests/test_torch_dma_exchange.py OUT.npz``) the
file is that subprocess.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.dma_exchange import (
    a2a_chunk_exchange,
    ficco_uniform_fused_1d_dma,
)
from repro_torch.tune.variants import KernelVariant, default_variant

_ROOT = Path(__file__).resolve().parents[1]
G = 4
# Per-rank shard of the composer: 4 chunks of 32 rows, so the step GEMM
# is (128, 128) @ (128, 256) and the 128-tile K1 branch is taken; the
# 2-chunk variant keeps m_c = 64, and the 3-chunk one falls back to g.
M_S, K, N_LOCAL = 128, 128, 256
CHUNK = (16, 128)
VARIANTS = {
    "default": dict(chunks=G, dispatch_order="forward"),
    "reverse": dict(chunks=G, dispatch_order="reverse"),
    "c2_reverse": dict(chunks=2, dispatch_order="reverse"),
    "c3_fallback": dict(chunks=3, dispatch_order="forward"),
}
# f32 on both sides; the reference's interpret-mode Pallas dots and
# PyTorch's CPU GEMM sum in different orders (the schedules' tolerance).
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(11)
    chunk = rng.standard_normal((G * CHUNK[0], CHUNK[1])).astype(np.float32)
    x = rng.standard_normal((G * M_S, K)).astype(np.float32)
    w = (rng.standard_normal((K, G * N_LOCAL)) / np.sqrt(K)).astype(
        np.float32
    )
    return chunk, x, w


def _variant(name):
    return KernelVariant(
        kernel="dma_exchange", block_m=128, block_n=128, block_k=128,
        **VARIANTS[name],
    )


def _reference_main(out_path):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={G} "
        + os.environ.get("XLA_FLAGS", "")
    )
    import dataclasses

    import jax
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.kernels.dma_exchange import (
        a2a_chunk_exchange as jax_exchange,
        ficco_uniform_fused_1d_dma as jax_composer,
    )
    from repro.tune import default_variant as jax_default_variant

    mesh = jax.make_mesh((G,), ("tp",))
    chunk, x, w = _inputs()
    results = {}
    for reverse in (False, True):
        fn = shard_map(
            lambda c, reverse=reverse: jax_exchange(
                c, axis_name="tp", group=G, interpret=True, reverse=reverse
            ),
            mesh=mesh, in_specs=P("tp", None),
            out_specs=P("tp", None, None), check_vma=False,
        )
        results[f"exchange_{int(reverse)}"] = np.asarray(jax.jit(fn)(chunk))
    base = jax_default_variant("dma_exchange", group=G)
    for name, fields in VARIANTS.items():
        v = dataclasses.replace(base, **fields)
        fn = shard_map(
            lambda xs, ws, v=v: jax_composer(
                xs, ws, axis_name="tp", interpret=True, variant=v
            ),
            mesh=mesh, in_specs=(P("tp", None), P(None, "tp")),
            out_specs=P(None, "tp"), check_vma=False,
        )
        results[f"composer_{name}"] = np.asarray(jax.jit(fn)(x, w))
    np.savez(out_path, **results)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dma_ref") / "ref.npz"
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


def _stack_rows(a):
    """Global (G*m, ...) rows -> stacked (G, m, ...) row shards."""
    return torch.from_numpy(a).reshape(G, a.shape[0] // G, *a.shape[1:])


def _stack_cols(a):
    """Global (k, G*n) -> stacked (G, k, n) column shards."""
    k, n = a.shape
    return torch.from_numpy(a).reshape(k, G, n // G).permute(1, 0, 2)


@pytest.mark.parametrize("reverse", [False, True])
def test_exchange_matches_reference(reference, reverse):
    chunk, _, _ = _inputs()
    got = a2a_chunk_exchange(_stack_rows(chunk), reverse=reverse)
    # reference: per device (G, m_c, K), concatenated over devices on dim 0
    want = reference[f"exchange_{int(reverse)}"].reshape(G, G, *CHUNK)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), ref.a2a_chunk_exchange_ref(_stack_rows(chunk)).numpy()
    )


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_composer_matches_reference(reference, name):
    _, x, w = _inputs()
    got = ficco_uniform_fused_1d_dma(
        _stack_rows(x), _stack_cols(w), variant=_variant(name)
    )
    # (G, G*m_s, n) rank blocks -> the global (G*m_s, G*n) product
    got_global = got.permute(1, 0, 2).reshape(G * M_S, G * N_LOCAL)
    np.testing.assert_allclose(
        got_global.numpy(), reference[f"composer_{name}"], **TOL
    )


def test_composer_orders_bit_equal_and_match_oracle():
    """Forward and reverse dispatch give the same bits; both equal the
    all-gather-then-GEMM oracle."""
    _, x, w = _inputs()
    xs, ws = _stack_rows(x), _stack_cols(w)
    outs = {
        name: ficco_uniform_fused_1d_dma(xs, ws, variant=_variant(name))
        for name in ("default", "reverse")
    }
    torch.testing.assert_close(
        outs["default"], outs["reverse"], rtol=0, atol=0
    )
    torch.testing.assert_close(
        outs["default"], ref.ag_matmul_ref(xs, ws), **TOL
    )


def test_ops_wrappers_take_plain_versions_on_cpu():
    from repro_torch.parallel.sharding import TPGroup

    _, x, w = _inputs()
    xs, ws = _stack_rows(x), _stack_cols(w)
    ops.reset_launch_counts()
    got = ops.ag_matmul_dma(xs, ws, group=TPGroup(G, "cpu"))
    ex = ops.chunk_exchange(xs[:, :16])
    assert ops.launch_counts() == {
        "chunked_matmul": 0, "accumulate_matmul": 0,
        "a2a_chunk_exchange": 0, "ficco_ag_matmul_fused": 0,
    }
    torch.testing.assert_close(got, ref.ag_matmul_ref(xs, ws), **TOL)
    assert ex.shape == (G, G, 16, K)


@pytest.mark.parametrize(
    "kernel", ["ficco_ag_matmul", "dma_exchange", "ficco_a2a_ffn"]
)
def test_default_variant_matches_reference(kernel):
    import dataclasses

    from repro.tune.variants import default_variant as jax_default_variant

    assert dataclasses.asdict(default_variant(kernel, group=G)) == (
        dataclasses.asdict(jax_default_variant(kernel, group=G))
    )


if __name__ == "__main__":
    _reference_main(sys.argv[1])
