"""K1 and K2: tiled GEMMs with an fp32 accumulator (``csrc/chunked_gemm.cu``).

Port of ``repro.kernels.chunked_gemm``.  :func:`chunked_matmul` (K1)
computes ``x @ w`` and :func:`accumulate_matmul` (K2) ``C += x @ w`` in
place, for one matrix or for ``g`` logical ranks at once (a leading rank
dim on every operand; the weight may be a strided column-shard view).  On
a CUDA tensor each launches the hand-written kernel, and on a CPU tensor it
takes its plain version in :mod:`repro_torch.kernels.ref`.  K1's block
arguments keep the reference's contract: a dim that does not divide its
block raises ``ValueError``.  They do not choose the CUDA kernel's own
tile, which masks its edges; for the same reason K2, whose reference took
plain ``jnp`` for shapes that do not tile, launches for every shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import accumulate_matmul_ref, matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("chunked_gemm")
    lib.chunked_gemm.restype = ctypes.c_int
    lib.chunked_gemm.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 6
        + [ctypes.c_void_p]
    )
    lib.accumulate_gemm.restype = ctypes.c_int
    lib.accumulate_gemm.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 6
        + [ctypes.c_void_p]
    )
    return lib


def _launch(x3: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    if x3.dtype not in _DTYPES or w3.dtype != x3.dtype:
        raise TypeError(
            f"chunked_matmul takes float32 or bfloat16 operands of one "
            f"dtype, got {x3.dtype} and {w3.dtype}"
        )
    if x3.device != w3.device:
        raise ValueError(f"operands on {x3.device} and {w3.device}")
    if x3.stride(-1) != 1 or w3.stride(-1) != 1:
        raise ValueError("chunked_matmul needs a contiguous last dim")
    g, m, k = x3.shape
    n = w3.shape[-1]
    out = torch.empty((g, m, n), dtype=x3.dtype, device=x3.device)
    lib = _lib()
    err = lib.chunked_gemm(
        x3.data_ptr(), w3.data_ptr(), out.data_ptr(), _DTYPES[x3.dtype],
        g, m, n, k,
        x3.stride(0), x3.stride(1),
        w3.stride(0), w3.stride(1),
        out.stride(0), out.stride(1),
        torch.cuda.current_stream(x3.device).cuda_stream,
    )
    _build.check(lib, "chunked_gemm", err)
    chunked_matmul.launches += 1
    return out


def chunked_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
    variant=None,
) -> torch.Tensor:
    """out = x @ w with the sum in fp32, cast to ``x.dtype``.

    x: (M, K) and w: (K, N) -> (M, N); or x: (g, M, K) and w: (g, K, N)
    -> (g, M, N), rank r multiplying x[r] by w[r].  All dims must divide
    their blocks.  A :class:`repro_torch.tune.KernelVariant` passed as
    ``variant`` overrides the three block arguments with its tile.
    """
    if variant is not None:
        block_m = int(variant.block_m)
        block_n = int(variant.block_n)
        block_k = int(variant.block_k)
    if x.dim() not in (2, 3) or w.dim() != x.dim():
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape[-2:]
    k2, n = w.shape[-2:]
    if k != k2 or (x.dim() == 3 and x.shape[0] != w.shape[0]):
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(
            f"({m},{n},{k}) not divisible by blocks "
            f"({block_m},{block_n},{block_k})"
        )
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"chunked_matmul runs on cuda or cpu, not {x.device}")
    if x.dim() == 2:
        return _launch(x.unsqueeze(0), w.unsqueeze(0))[0]
    return _launch(x, w)


# Kernel launches since the last reset (CUDA path only).
chunked_matmul.launches = 0


def _launch_accumulate(c3, x3, w3) -> None:
    if x3.dtype not in _DTYPES or w3.dtype != x3.dtype or (
        c3.dtype not in (torch.float32, x3.dtype)
    ):
        raise TypeError(
            f"accumulate_matmul takes C, x, w all float32, all bfloat16, or "
            f"a float32 C with bfloat16 operands, got {c3.dtype}, "
            f"{x3.dtype} and {w3.dtype}"
        )
    if not c3.device == x3.device == w3.device:
        raise ValueError(
            f"operands on {c3.device}, {x3.device} and {w3.device}"
        )
    if c3.stride(-1) != 1 or x3.stride(-1) != 1 or w3.stride(-1) != 1:
        raise ValueError("accumulate_matmul needs a contiguous last dim")
    g, m, k = x3.shape
    n = w3.shape[-1]
    lib = _lib()
    err = lib.accumulate_gemm(
        c3.data_ptr(), x3.data_ptr(), w3.data_ptr(),
        _DTYPES[c3.dtype], _DTYPES[x3.dtype],
        g, m, n, k,
        x3.stride(0), x3.stride(1),
        w3.stride(0), w3.stride(1),
        c3.stride(0), c3.stride(1),
        torch.cuda.current_stream(x3.device).cuda_stream,
    )
    _build.check(lib, "chunked_gemm", err)
    accumulate_matmul.launches += 1


def accumulate_matmul(
    c: torch.Tensor, x: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """C += x @ w in place, the sum in fp32 seeded from C; returns C.

    c: (M, N), x: (M, K), w: (K, N); or a leading rank dim g on all three.
    The 2D schedule's per-step accumulating GEMM (paper §IV-C1): C is its
    fp32 accumulator and x, w its bf16 K-slice panel and weight slice.
    """
    if x.dim() not in (2, 3) or not c.dim() == w.dim() == x.dim():
        raise ValueError(
            f"shapes {tuple(c.shape)} += {tuple(x.shape)} @ {tuple(w.shape)}"
        )
    m, k = x.shape[-2:]
    n = w.shape[-1]
    if (w.shape[-2] != k or c.shape[-2:] != (m, n)
            or (x.dim() == 3 and not c.shape[0] == x.shape[0] == w.shape[0])):
        raise ValueError(
            f"shapes {tuple(c.shape)} += {tuple(x.shape)} @ {tuple(w.shape)}"
        )
    if x.device.type == "cpu":
        return accumulate_matmul_ref(c, x, w)
    if x.device.type != "cuda":
        raise ValueError(f"accumulate_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    if x.dim() == 2:
        _launch_accumulate(c.unsqueeze(0), x.unsqueeze(0), w.unsqueeze(0))
    else:
        _launch_accumulate(c, x, w)
    return c


# Kernel launches since the last reset (CUDA path only).
accumulate_matmul.launches = 0

__all__ = ["chunked_matmul", "accumulate_matmul"]
