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

Each kernel picks its route here, by :func:`route` (K1) and
:func:`accumulate_route` (K2), and the C side launches that route or
refuses the operands; nothing falls back.  ``"wgmma"`` is the persistent
Hopper main loop of ``csrc/gemm_wgmma.cuh`` (TMA through an mbarrier ring
into ``wgmma``) for bf16 operands whose bases are 16-byte aligned and
whose strides are multiples of 16 bytes; K2 takes it for an fp32 C, which
its epilogue adds the product into with TMA's reduce-add.  ``"simt"``
takes f32, a bf16 C and every other shape.  ``chunked_matmul.routes``
and ``accumulate_matmul.routes`` count the launches of each route.

Gradients: K2 is the 2D schedule's step, which the reference writes in
plain ``jnp`` and differentiates, so :func:`accumulate_matmul` runs through
an autograd Function on both devices; its backward is the plain products
that autodiff takes of ``C + x @ w`` (no kernel of the reference computes
them).  K1 has no reverse-mode rule in the reference (``pallas_call`` has
none), so :func:`chunked_matmul` refuses an operand that needs a gradient
(:func:`refuse_grad`) rather than return a product autograd cannot see.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import accumulate_matmul_ref, matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Codes 0, 1, 2 of the C entry points; K1 and K2 take simt and wgmma,
# only K4 the wmma tile.
ROUTES = ("simt", "wmma", "wgmma")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through ``what``.

    The launches write through ``ctypes``, which autograd does not see, and
    the reference's Pallas kernels have no reverse-mode rule: this is
    checked on the CPU path too, so both devices refuse alike.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} cannot be differentiated: the reference's Pallas "
            "kernel has no reverse-mode rule (pallas_call); run it under "
            "torch.no_grad(), or train through the collective backend"
        )


def aligned16(t: torch.Tensor) -> bool:
    """Base 16-byte aligned and every stride but the last a multiple of 16
    bytes: what TMA's tensor maps and the tensor-core tiles' 16-byte loads
    need."""
    esize = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s * esize % 16 == 0 for s in t.stride()[:-1]
    )


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The route a CUDA launch of ``chunked_matmul(x, w)`` takes.

    ``"wgmma"`` for bf16 operands that :func:`aligned16` takes, with an
    output width N that keeps the output's rows 16-byte aligned;
    ``"simt"`` for f32 and the rest.
    """
    if (x.dtype == torch.bfloat16 and aligned16(x) and aligned16(w)
            and w.shape[-1] % 8 == 0):
        return "wgmma"
    return "simt"


def accumulate_route(c: torch.Tensor, x: torch.Tensor,
                     w: torch.Tensor) -> str:
    """The route a CUDA launch of ``accumulate_matmul(c, x, w)`` takes.

    ``"wgmma"`` for an fp32 C with bf16 operands, all three taken by
    :func:`aligned16` (the 2D schedule's step); ``"simt"`` for f32
    operands, a bf16 C and the rest.
    """
    if (c.dtype == torch.float32 and x.dtype == torch.bfloat16
            and w.dtype == torch.bfloat16
            and aligned16(c) and aligned16(x) and aligned16(w)):
        return "wgmma"
    return "simt"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("chunked_gemm")
    lib.chunked_gemm.restype = ctypes.c_int
    lib.chunked_gemm.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 6
        + [ctypes.c_void_p]
    )
    lib.accumulate_gemm.restype = ctypes.c_int
    lib.accumulate_gemm.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 6
        + [ctypes.c_void_p]
    )
    return lib


def _launch(x3: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """One launch over the stacked ranks, on ``route(x3, w3)``."""
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
    name = route(x3, w3)
    lib = _lib()
    err = lib.chunked_gemm(
        x3.data_ptr(), w3.data_ptr(), out.data_ptr(), _DTYPES[x3.dtype],
        ROUTES.index(name), g, m, n, k,
        x3.stride(0), x3.stride(1),
        w3.stride(0), w3.stride(1),
        out.stride(0), out.stride(1),
        torch.cuda.current_stream(x3.device).cuda_stream,
    )
    _build.check(lib, "chunked_gemm", err)
    chunked_matmul.launches += 1
    chunked_matmul.routes[name] += 1
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
    refuse_grad("chunked_matmul (K1)", x, w)
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"chunked_matmul runs on cuda or cpu, not {x.device}")
    if x.dim() == 2:
        return _launch(x.unsqueeze(0), w.unsqueeze(0))[0]
    return _launch(x, w)


# Kernel launches since the last reset (CUDA path only), in all and by
# route.
chunked_matmul.launches = 0
chunked_matmul.routes = dict.fromkeys(("simt", "wgmma"), 0)


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
    name = accumulate_route(c3, x3, w3)
    lib = _lib()
    err = lib.accumulate_gemm(
        c3.data_ptr(), x3.data_ptr(), w3.data_ptr(),
        _DTYPES[c3.dtype], _DTYPES[x3.dtype], ROUTES.index(name),
        g, m, n, k,
        x3.stride(0), x3.stride(1),
        w3.stride(0), w3.stride(1),
        c3.stride(0), c3.stride(1),
        torch.cuda.current_stream(x3.device).cuda_stream,
    )
    _build.check(lib, "chunked_gemm", err)
    accumulate_matmul.launches += 1
    accumulate_matmul.routes[name] += 1


class _AccumulateMatmul(torch.autograd.Function):
    """``C += x @ w`` in place, recorded for autograd.

    Forward: K2 on CUDA, its plain version on the CPU, into C's storage
    (``mark_dirty``).  Backward, per rank: dC passes through, dx = dC @ wᵀ
    and dw = xᵀ @ dC, with dC cast to the operands' dtype, the products
    that autodiff takes of the reference's ``acc + (panel @ w_slice)``.
    The saved x is the step's gathered panel, so nothing is gathered again.
    """

    @staticmethod
    def forward(ctx, c, x, w):
        if x.device.type == "cpu":
            accumulate_matmul_ref(c, x, w)
        elif x.device.type != "cuda":
            raise ValueError(f"accumulate_matmul runs on cuda or cpu, not "
                             f"{x.device}")
        elif x.dim() == 2:
            _launch_accumulate(c.unsqueeze(0), x.unsqueeze(0), w.unsqueeze(0))
        else:
            _launch_accumulate(c, x, w)
        ctx.mark_dirty(c)
        ctx.save_for_backward(x, w)
        return c

    @staticmethod
    def backward(ctx, dc):
        x, w = ctx.saved_tensors
        d = dc.to(x.dtype)
        dx = torch.matmul(d, w.transpose(-1, -2)) \
            if ctx.needs_input_grad[1] else None
        dw = torch.matmul(x.transpose(-1, -2), d) \
            if ctx.needs_input_grad[2] else None
        return dc, dx, dw


def accumulate_matmul(
    c: torch.Tensor, x: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """C += x @ w in place, the sum in fp32; returns C.

    c: (M, N), x: (M, K), w: (K, N); or a leading rank dim g on all three.
    The 2D schedule's per-step accumulating GEMM (paper §IV-C1): C is its
    fp32 accumulator and x, w its bf16 K-slice panel and weight slice.
    The sum is C + (x @ w), as the plain version takes it ("wgmma" adds
    the product into C; "simt" seeds its sum from C, as the TPU kernel
    does: the two differ in rounding only).  With gradients enabled the
    update is recorded for autograd (:class:`_AccumulateMatmul`), so C's
    later uses differentiate through x and w on both devices.
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
    return _AccumulateMatmul.apply(c, x, w)


# Kernel launches since the last reset (CUDA path only), in all and by
# route.
accumulate_matmul.launches = 0
accumulate_matmul.routes = dict.fromkeys(("simt", "wgmma"), 0)

__all__ = [
    "ROUTES",
    "refuse_grad",
    "aligned16",
    "route",
    "accumulate_route",
    "chunked_matmul",
    "accumulate_matmul",
]
