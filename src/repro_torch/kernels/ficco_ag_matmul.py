"""K4: the fused FiCCO all-gather-matmul (``csrc/ficco_ag_matmul.cu``).

Port of ``repro.kernels.ficco_ag_matmul.ficco_ag_matmul_fused``: one launch
computes, for every logical rank r, ``all_gather(x) @ w[r]`` with an fp32
sum cast to ``x.dtype``.  The kernel reads each A row straight from its
owner's shard through a per-rank pointer table and writes each output row
straight into its final row, so no gather and no scatter pass runs.  On a
CPU tensor the wrapper takes the plain version
:func:`repro_torch.kernels.ref.ag_matmul_ref`.

The :class:`repro_torch.tune.KernelVariant` keeps the reference's meaning:
``chunks`` cuts each shard into pipeline steps (falling back to one chunk
per rank when it does not divide the shard), ``dispatch_order`` orders the
steps' tiles, and every variant gives the same bits.  ``buffer_depth`` is
checked and clamped as the reference clamps it, but moves nothing here:
on one card the ranks' shards are all in device memory, so there is no
step-buffer ring to rotate.  The ring, with its push and release-flag
protocol, comes with groups over several cards (ROADMAP A9).

The wrapper picks the route by :func:`route`, from the operands alone and
never from the variant, and the C side launches it or refuses the
operands: ``"wgmma"`` (the persistent TMA + ``wgmma`` main loop of
``csrc/gemm_wgmma.cuh``, one tensor map per rank's shard) for aligned bf16
operands of a group of at most ``MAX_WGMMA_RANKS``; ``"wmma"`` (the older
tile of ``csrc/gemm_tile.cuh``, rows read through a pointer table) for
larger groups it takes; ``"simt"`` for f32 and the rest.
``ficco_ag_matmul_fused.routes`` counts the launches of each route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunked_gemm import ROUTES, aligned16, refuse_grad
from repro_torch.kernels.ref import ag_matmul_ref
from repro_torch.tune.registry import resolve_variant

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_RANKS = 64  # MAX_RANKS in the CUDA source
MAX_WGMMA_RANKS = 16  # MAX_WGMMA_RANKS in the CUDA source


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The route a CUDA launch of ``ficco_ag_matmul_fused(x, w)`` takes,
    for any variant.

    ``"wgmma"`` for bf16 shards and weight that
    :func:`~repro_torch.kernels.chunked_gemm.aligned16` takes, an output
    width that keeps the output's rows 16-byte aligned, and a group of at
    most ``MAX_WGMMA_RANKS``; ``"wmma"`` for other aligned bf16 operands
    with a 128-multiple width and 32-multiple K; ``"simt"`` otherwise.
    """
    g, _, k = x.shape
    n = w.shape[-1]
    if x.dtype != torch.bfloat16 or not (aligned16(x) and aligned16(w)):
        return "simt"
    if g <= MAX_WGMMA_RANKS and n % 8 == 0:
        return "wgmma"
    if n % 128 == 0 and k % 32 == 0:
        return "wmma"
    return "simt"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ficco_ag_matmul")
    lib.ficco_ag_matmul.restype = ctypes.c_int
    lib.ficco_ag_matmul.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 5
        + [ctypes.c_void_p]
    )
    return lib


def _launch(x, w, out, steps: int, depth: int, reverse: bool) -> None:
    """One launch, on ``route(x, w)``."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(
            f"ficco_ag_matmul_fused takes float32 or bfloat16 operands of "
            f"one dtype, got {x.dtype} and {w.dtype}"
        )
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if x.stride(-1) != 1 or w.stride(-1) != 1:
        raise ValueError("ficco_ag_matmul_fused needs a contiguous last dim")
    g, m_s, k = x.shape
    if g > _MAX_RANKS:
        raise ValueError(f"group of {g} ranks; the kernel takes up to "
                         f"{_MAX_RANKS}")
    esize = x.element_size()
    table = (ctypes.c_void_p * g)(*[
        x.data_ptr() + r * x.stride(0) * esize for r in range(g)
    ])
    name = route(x, w)
    lib = _lib()
    err = lib.ficco_ag_matmul(
        table, g, w.data_ptr(), out.data_ptr(), _DTYPES[x.dtype],
        ROUTES.index(name), m_s, w.shape[-1], k, steps, depth,
        int(reverse),
        x.stride(1), w.stride(0), w.stride(1), out.stride(0), out.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, "ficco_ag_matmul", err)
    ficco_ag_matmul_fused.launches += 1
    ficco_ag_matmul_fused.routes[name] += 1


def _plan(variant, g: int, m_s: int) -> tuple[int, int, bool]:
    """(steps, buffer depth, reverse) of ``variant`` on g shards of m_s rows."""
    steps = int(variant.chunks)
    if m_s % steps:
        steps = g  # promoted cut doesn't divide this shard; classic cut
    if m_s % steps:
        raise ValueError(f"{m_s} shard rows not divisible by {steps} chunks")
    depth = max(2, min(int(variant.buffer_depth), steps))
    return steps, depth, variant.dispatch_order == "reverse"


def ficco_ag_matmul_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    variant=None,
) -> torch.Tensor:
    """all_gather(x) @ w on every rank, in one launch.

    x: (g, m_s, K), rank r's row shard; w: (g, K, n_local), rank r's
    column shard -> (g, g * m_s, n_local), rank r's column block of the
    full product, in ``x.dtype``.  ``variant=None`` resolves the promoted
    default from :mod:`repro_torch.tune.registry`.  Operands that need a
    gradient are refused
    (:func:`~repro_torch.kernels.chunked_gemm.refuse_grad`): the reference
    kernel has no reverse-mode rule.
    """
    refuse_grad("ficco_ag_matmul_fused (K4)", x, w)
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"shards {tuple(x.shape)} and {tuple(w.shape)}")
    g, m_s, k = x.shape
    n_local = w.shape[-1]
    if w.shape != (g, k, n_local):
        raise ValueError(f"shards {tuple(x.shape)} and {tuple(w.shape)}")
    if variant is None:
        variant = resolve_variant("ficco_ag_matmul", group=g)
    steps, depth, reverse = _plan(variant, g, m_s)
    if x.device.type == "cpu":
        return ag_matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"ficco_ag_matmul_fused runs on cuda or cpu, not "
                         f"{x.device}")
    out = torch.empty((g, g * m_s, n_local), dtype=x.dtype, device=x.device)
    _launch(x, w, out, steps, depth, reverse)
    return out


# Kernel launches since the last reset (CUDA path only), in all and by
# route.
ficco_ag_matmul_fused.launches = 0
ficco_ag_matmul_fused.routes = dict.fromkeys(ROUTES, 0)

__all__ = ["MAX_WGMMA_RANKS", "route", "ficco_ag_matmul_fused"]
