"""The port's K1 ``chunked_matmul`` and K2 ``accumulate_matmul`` (plain
versions on the CPU) vs the reference's Pallas kernels in interpret mode.

Shapes, dtypes and tolerances are those of ``tests/test_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunked_gemm import chunked_matmul as jax_chunked_matmul
from repro_torch.kernels import ops
from repro_torch.kernels.chunked_gemm import accumulate_matmul, chunked_matmul
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


# ---------------------------------------------------------------------------
# K2: accumulate_matmul (C += x @ w in place)
# ---------------------------------------------------------------------------

# tests/test_kernels.py's SHAPES plus one shape that tiles no block, where
# the reference takes plain jnp and the port's kernel masks its edges.
ACC_SHAPES = SHAPES + [(100, 60, 30)]


@pytest.mark.parametrize("m,n,k", ACC_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_accumulate_matmul_matches_reference(m, n, k, dtype):
    from repro.kernels.chunked_gemm import (
        accumulate_matmul as jax_accumulate_matmul,
    )

    rng = np.random.default_rng(7 * m + n + k)
    cj, ct = _both(rng.standard_normal((m, n)).astype(np.float32), dtype)
    xj, xt = _both(rng.standard_normal((m, k)).astype(np.float32), dtype)
    wj, wt = _both(rng.standard_normal((k, n)).astype(np.float32), dtype)
    want = np.asarray(
        jax_accumulate_matmul(cj, xj, wj, interpret=True), np.float32
    )
    got = accumulate_matmul(ct, xt, wt)
    assert got is ct and got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))


def test_accumulate_matmul_mixed_dtypes_match_reference_oracle():
    """The 2D schedule's case: an fp32 C with bf16 operands."""
    from repro.kernels.ref import accumulate_matmul_ref as jax_ref

    rng = np.random.default_rng(8)
    c = rng.standard_normal((4, 256, 128)).astype(np.float32)
    x = rng.standard_normal((4, 256, 64)).astype(np.float32)
    w = rng.standard_normal((4, 64, 128)).astype(np.float32)
    want = np.asarray(jax.vmap(jax_ref)(
        jnp.asarray(c), jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(w, jnp.bfloat16),
    ))
    got = accumulate_matmul(
        torch.from_numpy(c), torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(w).to(torch.bfloat16),
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_accumulate_matmul_updates_c_in_place():
    rng = np.random.default_rng(9)
    c = torch.from_numpy(rng.standard_normal((4, 64, 32)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 64, 16)).astype(np.float32))
    w_full = torch.from_numpy(
        rng.standard_normal((16, 4 * 32)).astype(np.float32)
    )
    w = w_full.view(16, 4, 32).permute(1, 0, 2)  # strided column shards
    before = c.clone()
    ptr = c.data_ptr()
    ops.reset_launch_counts()
    out = ops.matmul_accumulate(c, x, w)
    assert out is c and c.data_ptr() == ptr
    assert ops.launch_counts()["accumulate_matmul"] == 0  # plain on the CPU
    torch.testing.assert_close(c, before + torch.matmul(x, w),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shapes", [
    ((64, 32), (64, 16), (8, 32)),  # K mismatch
    ((64, 16), (64, 16), (16, 32)),  # C is not (M, N)
    ((2, 64, 32), (3, 64, 16), (3, 16, 32)),  # rank dims differ
])
def test_accumulate_matmul_rejects_bad_shapes(shapes):
    c, x, w = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        accumulate_matmul(c, x, w)
