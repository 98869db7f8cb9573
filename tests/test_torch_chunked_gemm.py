"""The port's K1 ``chunked_matmul`` (plain version on the CPU) vs the
reference's Pallas ``chunked_matmul`` in interpret mode.

Shapes, dtypes and tolerances are those of ``tests/test_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunked_gemm import chunked_matmul as jax_chunked_matmul
from repro_torch.kernels import ops
from repro_torch.kernels.chunked_gemm import chunked_matmul
from repro_torch.tune.variants import default_variant

SHAPES = [
    (128, 128, 128),
    (256, 128, 384),
    (384, 256, 128),
    (128, 384, 256),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (
        dict(rtol=2e-2, atol=2e-2)
        if name == "bfloat16"
        # fp32 dots reassociate across K blocks -> not bit-equal
        else dict(rtol=1e-4, atol=1e-4)
    )


def _both(a, name):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunked_matmul_matches_reference(m, n, k, dtype):
    rng = np.random.default_rng(m + n + k)
    xj, xt = _both(rng.standard_normal((m, k)).astype(np.float32), dtype)
    wj, wt = _both(rng.standard_normal((k, n)).astype(np.float32), dtype)
    want = np.asarray(jax_chunked_matmul(xj, wj, interpret=True), np.float32)
    got = chunked_matmul(xt, wt)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))


def test_rank_batched_matches_per_rank():
    """A leading rank dim (and a strided column-shard weight) is g
    independent products."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 128, 256)).astype(np.float32))
    w_full = torch.from_numpy(
        rng.standard_normal((256, 4 * 128)).astype(np.float32)
    )
    w = w_full.view(256, 4, 128).permute(1, 0, 2)
    got = chunked_matmul(x, w, variant=default_variant("dma_exchange"))
    for r in range(4):
        torch.testing.assert_close(got[r], x[r] @ w_full[:, r * 128:(r + 1) * 128],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(100, 128, 128), (128, 100, 128),
                                   (128, 128, 100)])
def test_indivisible_raises(shape):
    m, n, k = shape
    with pytest.raises(ValueError):
        chunked_matmul(torch.zeros((m, k)), torch.zeros((k, n)))


def test_ops_matmul_plain_on_cpu_counts_no_launch():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
    ops.reset_launch_counts()
    got = ops.matmul(x, w)
    assert ops.launch_counts()["chunked_matmul"] == 0
    torch.testing.assert_close(got, x @ w, rtol=1e-5, atol=1e-5)
