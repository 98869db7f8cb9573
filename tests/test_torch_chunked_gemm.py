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

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

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


# ---------------------------------------------------------------------------
# K1's route choice (the wrapper picks it; the C side launches it or
# refuses).  Shapes only: the tensors stay on the CPU.
# ---------------------------------------------------------------------------

def _path_operands():
    """The DMA path's step GEMM: 4 ranks x (512, 2048) @ a strided
    (2048, 1408) column shard of the (2048, 5632) weight."""
    from repro_torch.parallel.sharding import shard_columns

    x = torch.zeros((4, 512, 2048), dtype=torch.bfloat16)
    w = shard_columns(torch.zeros((2048, 5632), dtype=torch.bfloat16), 4)
    return x, w


def _route_case(name):
    bf16, f32 = torch.bfloat16, torch.float32
    if name == "path_shard_columns":
        return _path_operands()
    if name == "edge_2d":  # M, N not multiples of 128, K not of 64
        return torch.zeros((200, 200), dtype=bf16), torch.zeros((200, 328),
                                                                dtype=bf16)
    if name == "f32":
        x, w = _path_operands()
        return x.float(), w.float()
    if name == "f32_small":
        return torch.zeros((128, 128), dtype=f32), torch.zeros((128, 128),
                                                               dtype=f32)
    if name == "unaligned_row_stride":  # K = 30: rows 60 bytes apart
        return torch.zeros((64, 30), dtype=bf16), torch.zeros((30, 128),
                                                              dtype=bf16)
    if name == "unaligned_base":  # x starts 2 bytes into its storage
        x = torch.zeros((64 * 64 + 1,), dtype=bf16)[1:].view(64, 64)
        return x, torch.zeros((64, 128), dtype=bf16)
    if name == "unaligned_width":  # N = 100 in a padded weight
        return torch.zeros((64, 64), dtype=bf16), torch.zeros(
            (64, 104), dtype=bf16)[:, :100]
    raise KeyError(name)


@pytest.mark.parametrize("name,want", [
    ("path_shard_columns", "wgmma"),
    ("edge_2d", "wgmma"),
    ("f32", "simt"),
    ("f32_small", "simt"),
    # The wmma tile needs the same 16-byte alignment (and more), so an
    # unaligned stride, base or width leaves both tensor-core routes.
    ("unaligned_row_stride", "simt"),
    ("unaligned_base", "simt"),
    ("unaligned_width", "simt"),
])
def test_route_choice(name, want):
    from repro_torch.kernels.chunked_gemm import route

    x, w = _route_case(name)
    assert route(x, w) == want


def test_path_weight_strides_fit_tma():
    """The shard_columns view's strides: 5632 elements per row (11 264 B)
    and 1408 per rank (2816 B), both 16-byte multiples."""
    from repro_torch.kernels.chunked_gemm import aligned16

    _, w = _path_operands()
    assert w.stride() == (1408, 5632, 1)
    assert aligned16(w)


def test_cpu_call_counts_no_route():
    x, w = _path_operands()
    x, w = x[:, :8, :64], w[:, :64, :8]  # a small slice, same strides
    ops.reset_launch_counts()
    chunked_matmul(x, w, block_m=8, block_n=8, block_k=64)
    assert ops.launch_counts()["chunked_matmul"] == 0
    assert all(v == 0 for by_route in ops.route_counts().values()
               for v in by_route.values())


# ---------------------------------------------------------------------------
# K2's route choice: "wgmma" for the 2D schedule's fp32 C with bf16
# operands, "simt" for the rest.  Shapes only: the tensors stay on the CPU.
# ---------------------------------------------------------------------------

def _accumulate_case(name):
    """(C, x, w) of one case; the path's is the 2D schedule's step: C (4,
    2048, 1408) fp32 += panel (4, 2048, 512) bf16 @ a K slice of the
    strided (2048, 1408) weight shard."""
    from repro_torch.parallel.sharding import shard_columns

    bf16, f32 = torch.bfloat16, torch.float32
    c = torch.zeros((4, 2048, 1408), dtype=f32)
    x = torch.zeros((4, 2048, 512), dtype=bf16)
    w = shard_columns(torch.zeros((2048, 5632), dtype=bf16), 4)[:, 512:1024]
    if name == "path_2d_step":
        return c, x, w
    if name == "ragged_aligned":  # M, N, K not tile multiples
        return (torch.zeros((200, 200), dtype=f32),
                torch.zeros((200, 72), dtype=bf16),
                torch.zeros((72, 200), dtype=bf16))
    if name == "f32_operands":
        return c, x.float(), w.float()
    if name == "bf16_c":
        return c.to(bf16), x, w
    if name == "unaligned_k":  # K = 30: panel rows 60 bytes apart
        return (torch.zeros((64, 128), dtype=f32),
                torch.zeros((64, 30), dtype=bf16),
                torch.zeros((30, 128), dtype=bf16))
    if name == "unaligned_c_stride":  # C rows 520 bytes apart
        return (torch.zeros((64, 130), dtype=f32)[:, :128],
                torch.zeros((64, 64), dtype=bf16),
                torch.zeros((64, 128), dtype=bf16))
    if name == "unaligned_c_base":  # C starts 4 bytes into its storage
        return (torch.zeros((64 * 128 + 1,), dtype=f32)[1:].view(64, 128),
                torch.zeros((64, 64), dtype=bf16),
                torch.zeros((64, 128), dtype=bf16))
    raise KeyError(name)


@pytest.mark.parametrize("name,want", [
    ("path_2d_step", "wgmma"),
    ("ragged_aligned", "wgmma"),
    ("f32_operands", "simt"),
    ("bf16_c", "simt"),
    ("unaligned_k", "simt"),
    ("unaligned_c_stride", "simt"),
    ("unaligned_c_base", "simt"),
])
def test_accumulate_route_choice(name, want):
    from repro_torch.kernels.chunked_gemm import accumulate_route

    assert accumulate_route(*_accumulate_case(name)) == want


def test_path_accumulator_strides_fit_tma():
    """The 2D step's C rows are 1408 fp32 (5632 B) apart and its weight
    slice starts 512 rows (5.5 MiB) into the shard: all 16-byte multiples."""
    from repro_torch.kernels.chunked_gemm import aligned16

    c, x, w = _accumulate_case("path_2d_step")
    assert c.stride() == (2048 * 1408, 1408, 1)
    assert w.storage_offset() == 512 * 5632
    assert aligned16(c) and aligned16(x) and aligned16(w)


def test_accumulate_cpu_call_counts_no_route():
    c, x, w = _accumulate_case("path_2d_step")
    c, x, w = c[:, :8, :8].clone(), x[:, :8, :16], w[:, :16, :8]
    ops.reset_launch_counts()
    accumulate_matmul(c, x, w)
    assert ops.launch_counts()["accumulate_matmul"] == 0
    assert ops.route_counts()["accumulate_matmul"] == {"simt": 0, "wgmma": 0}
