#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit; build the CUDA kernels (one nvcc per
     source, in parallel) and print the build time;
  2. every kernel (K1-K4) against its plain PyTorch version on the card, at
     the reference's test shapes and at the shapes of the main path, with
     CUDA-event timings beside the plain version's and one PyTorch call's;
     K4's variants bit for bit against each other;
  3. the six FiCCO schedules through ``ficco_linear`` at the main path's
     projection shape, in bf16 and f32, against ``x_full @ w``, and what
     ``auto`` resolves to on the H100 machine model;
  4. the main paths: full-width TinyLlama-1.1B prefill (4 prompts x 512
     tokens) through ``make_prefill`` on a group of 4 logical ranks, once
     with the DMA-backend uniform-fused-1D TP MLP (K1 + K3) and once with
     the collective-backend uniform-fused-2D schedule (K2), each held
     against the dense forward, with the kernels' launch counts read around
     each; then the fused AG->GEMM (K4) over the same model's 44 up/gate
     projections through ``ops.ag_matmul_fused``, counted the same way;
  5. serving: ``DecodeEngine`` answers 4 requests on the same weights;
then one JSON line listing the kernels and, last, the result line.
With no CUDA device, or without the repository's ``src/repro_torch`` beside
it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor cores,
# fp32 outside the tensor cores, HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

PREFILL_BATCH, PREFILL_SEQ, GROUP = 4, 512, 4
# TinyLlama-1.1B's widths: the main path's projection is (4 * 512 tokens,
# D_MODEL) @ (D_MODEL, D_FF), column-sharded over GROUP ranks.
D_MODEL, D_FF = 2048, 5632
REPS = 20
# The reference's tolerances (tests/test_kernels.py, tests/multidev_*.py).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    import torch

    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Timer:
    """Median device time of ``fn`` over REPS runs (CUDA events), cold L2.

    The main path reads each layer's weights once, so before every run a
    buffer larger than the 50 MB L2 cache is rewritten, outside the timed
    region.  A spin kernel then holds the stream while the host enqueues
    ``fn``, so the events time the device's work and not the host's issue
    (which :func:`wall_ms` includes).
    """

    SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's SM clock

    def __init__(self, device):
        import torch

        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device=device)

    def __call__(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host wall time of ``fn`` run to completion (host issue
    included), after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _randn_fn(device, seed: int):
    """randn(*shape, dtype, scale) on ``device`` from a seeded generator."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    return randn


def _sync():
    import torch

    torch.cuda.synchronize()


def phase_build():
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.time()
    paths = _build.build()
    print(f"[build] {len(paths)} kernels built in {time.time() - t0:.1f}s "
          f"into {_build.BUILD_DIR}")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(device, timer):
    """Each kernel vs its plain version; returns the kernels' records."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.chunked_gemm import chunked_matmul
    from repro_torch.kernels.dma_exchange import (
        a2a_chunk_exchange,
        ficco_uniform_fused_1d_dma,
    )
    from repro_torch.parallel.sharding import TPGroup, shard_columns
    from repro_torch.tune.variants import KernelVariant

    randn = _randn_fn(device, 0)

    # K1 at the reference's tests/test_kernels.py shapes and tolerances.
    for m, n, k in [(128, 128, 128), (256, 128, 384), (384, 256, 128),
                    (128, 384, 256)]:
        for dtype, tol in [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]:
            x, w = randn(m, k, dtype=dtype), randn(k, n, dtype=dtype)
            got = chunked_matmul(x, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref.matmul_ref(x, w),
                                       rtol=tol, atol=tol)
    # bf16 at a shape the tensor-core tile does not take (CUDA-core path),
    # and at one whose rows it masks (192 rows: a half-empty second tile).
    for n, k in [(320, 96), (128, 64)]:
        x, w = randn(192, k, dtype=torch.bfloat16), randn(
            k, n, dtype=torch.bfloat16)
        got = chunked_matmul(x, w, block_m=64, block_n=64, block_k=32)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.matmul_ref(x, w), rtol=2e-2,
                                   atol=2e-2)
    print("[kernels] K1 chunked_matmul matches matmul_ref at the 4 "
          "test_kernels shapes, f32 (1e-4) and bf16 (2e-2), and at "
          "192x320x96 (CUDA cores) and 192x128x64 (masked tensor-core "
          "tile) bf16")

    # K1 at the main path's step GEMM: 4 ranks x (g*m_c=512, K=2048) @
    # (2048, n_local=1408), the weight a strided column-shard view.
    d_model, d_ff = D_MODEL, D_FF
    rows = PREFILL_BATCH * PREFILL_SEQ // GROUP  # g * m_c
    x = randn(GROUP, rows, d_model, dtype=torch.bfloat16)
    w = shard_columns(
        randn(d_model, d_ff, dtype=torch.bfloat16, scale=d_model ** -0.5),
        GROUP,
    )
    got = chunked_matmul(x, w, block_k=d_model)
    torch.cuda.synchronize()
    want = ref.matmul_ref(x, w)
    # bf16 output: both sum in fp32, in different orders, so an element
    # may round to the neighbouring bf16 value (reference's bf16 tol).
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    k1_err = _max_err(got, want)
    out = torch.empty_like(got)
    k1_flops = 2 * GROUP * rows * d_model * (d_ff // GROUP)
    k1_bound, k1_by = _bound(k1_flops, _nbytes(x, w, out), x.dtype)
    k1 = dict(
        name="chunked_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/chunked_gemm.cu",
        replaces="src/repro/kernels/chunked_gemm.py:39",
        max_abs_err=k1_err,
        ms=timer(lambda: chunked_matmul(x, w, block_k=d_model)),
        plain_ms=timer(lambda: ref.matmul_ref(x, w)),
        bound_ms=k1_bound, bound_by=k1_by,
        library_ms=timer(lambda: torch.matmul(x, w)),
    )
    print(f"[kernels] K1 path shape {GROUP}x{rows}x{d_model}x{d_ff // GROUP} "
          f"bf16: max_abs_err {k1_err:.3e}, {k1['ms']:.4f} ms (plain "
          f"{k1['plain_ms']:.4f}, torch.matmul {k1['library_ms']:.4f}, "
          f"bound {k1_bound:.4f} {k1_by})")

    # K3 at the main path's chunk: 4 ranks x (m_c=128, K=2048) bf16.
    m_c = rows // GROUP
    chunks = randn(GROUP, m_c, d_model, dtype=torch.bfloat16)
    want = ref.a2a_chunk_exchange_ref(chunks)
    k3_err = 0.0
    for reverse in (False, True):
        got = a2a_chunk_exchange(chunks, reverse=reverse)
        torch.cuda.synchronize()
        k3_err = max(k3_err, _max_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"K3 (reverse={reverse}) is not bit-equal "
                                 "to a2a_chunk_exchange_ref")
    buf = torch.empty_like(want)
    k3_bound, k3_by = _bound(0, _nbytes(chunks, buf), chunks.dtype)
    k3 = dict(
        name="a2a_chunk_exchange", route="cuda",
        source="src/repro_torch/kernels/csrc/dma_exchange.cu",
        replaces="src/repro/kernels/dma_exchange.py:91",
        max_abs_err=k3_err,
        ms=timer(lambda: a2a_chunk_exchange(chunks, out=buf)),
        plain_ms=timer(lambda: ref.a2a_chunk_exchange_ref(chunks, out=buf)),
        bound_ms=k3_bound, bound_by=k3_by,
        library_ms=timer(
            lambda: buf.copy_(chunks.unsqueeze(0).expand_as(buf))
        ),
    )
    k3_wall = wall_ms(lambda: a2a_chunk_exchange(chunks, out=buf), REPS)
    print(f"[kernels] K3 {GROUP}x{GROUP} copies of {m_c}x{d_model} bf16, "
          f"forward and reverse bit-equal; {k3['ms']:.4f} ms on the device "
          f"({k3_wall:.4f} ms host wall per call) (plain "
          f"{k3['plain_ms']:.4f}, broadcast copy_ {k3['library_ms']:.4f}, "
          f"bound {k3_bound:.4f} {k3_by})")

    # The composer at the main path's per-rank shard (m_s = 512 rows).
    group = TPGroup(GROUP, device)
    xs = randn(GROUP, rows, d_model, dtype=torch.bfloat16)
    fwd = ops.ag_matmul_dma(xs, w, group=group)
    rev_variant = KernelVariant(
        kernel="dma_exchange", chunks=GROUP, block_m=128, block_n=128,
        block_k=128, dispatch_order="reverse",
    )
    rev = ficco_uniform_fused_1d_dma(xs, w, variant=rev_variant,
                                     copy_stream=group.copy_stream)
    oracle = ref.ag_matmul_ref(xs, w)
    torch.cuda.synchronize()
    if not torch.equal(fwd, rev):
        raise AssertionError("composer forward and reverse orders differ")
    torch.testing.assert_close(fwd, oracle, rtol=2e-2, atol=2e-2)
    fused_ms = timer(lambda: ops.ag_matmul_dma(xs, w, group=group))
    serial_ms = timer(lambda: ref.ag_matmul_ref(xs, w))
    print(f"[kernels] composer uniform-fused-1d (4 steps): forward == "
          f"reverse bit for bit, max_abs_err vs all-gather+GEMM "
          f"{_max_err(fwd, oracle):.3e}; {fused_ms:.4f} ms per call "
          f"(all-gather + torch.matmul: {serial_ms:.4f} ms)")

    def composer_ahead():
        # The host enqueues 5 calls while a spin kernel holds the stream,
        # so the device runs them back to back as the schedule allows.
        torch.cuda._sleep(Timer.SPIN_CYCLES)
        for _ in range(5):
            ops.ag_matmul_dma(xs, w, group=group)

    phase_trace("5 composer calls, host ahead", composer_ahead)
    return [k1, k3]


def phase_accumulate(device, timer):
    """K2 vs its plain version at the reference's shapes and the 2D
    schedule's step; returns its record."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_gemm import accumulate_matmul
    from repro_torch.parallel.sharding import shard_columns

    randn = _randn_fn(device, 2)
    f32, bf16 = torch.float32, torch.bfloat16

    def check(c, x, w, tol, what):
        want = ref.accumulate_matmul_ref(c.clone(), x, w)
        ptr = c.data_ptr()
        got = accumulate_matmul(c, x, w)
        _sync()
        if got is not c or c.data_ptr() != ptr:
            raise AssertionError(f"K2 {what}: C was not updated in place")
        torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                                   msg=lambda m: f"K2 {what}: {m}")
        return _max_err(got, want)

    # tests/test_kernels.py's shapes and tolerances (1e-4 for a K-blocked
    # f32 GEMM, 2e-2 bf16), one shape no tile divides, one whose rows the
    # tensor-core tile masks, and the 2D schedule's mix of an fp32 C with
    # bf16 operands.
    for m, n, k in [(128, 128, 128), (256, 128, 384), (384, 256, 128),
                    (128, 384, 256), (100, 60, 30), (192, 128, 64)]:
        for dtype, tol in [(f32, 1e-4), (bf16, 2e-2)]:
            check(randn(m, n, dtype=dtype), randn(m, k, dtype=dtype),
                  randn(k, n, dtype=dtype), tol, f"{m}x{n}x{k} {dtype}")
        check(randn(m, n, dtype=f32), randn(m, k, dtype=bf16),
              randn(k, n, dtype=bf16), 1e-4, f"{m}x{n}x{k} mixed")
    print("[kernels] K2 accumulate_matmul matches accumulate_matmul_ref in "
          "place at the 4 test_kernels shapes, 100x60x30 and 192x128x64, "
          "f32 (1e-4), bf16 (2e-2) and f32 C with bf16 operands (1e-4)")

    # The 2D schedule's step at the main path: C (4 ranks x 2048 x 1408)
    # fp32 += panel (2048 x 512) bf16 @ a K-slice of the strided weight
    # shard (512 x 1408).
    rows, k_c, n_local = PREFILL_BATCH * PREFILL_SEQ, D_MODEL // GROUP, \
        D_FF // GROUP
    c = randn(GROUP, rows, n_local, dtype=f32)
    panel = randn(GROUP, rows, k_c, dtype=bf16)
    w = shard_columns(
        randn(D_MODEL, D_FF, dtype=bf16, scale=D_MODEL ** -0.5), GROUP
    )[:, k_c:2 * k_c]
    err = check(c, panel, w, 1e-4, "path shape")
    flops = 2 * GROUP * rows * k_c * n_local
    bound, by = _bound(flops, _nbytes(c, c, panel, w), bf16)
    # The fastest single PyTorch call for C + x @ w with an fp32 sum:
    # baddbmm with an fp32 out_dtype over bf16 operands.
    library = timer(lambda: torch.baddbmm(c, panel, w, out_dtype=f32))
    rec = dict(
        name="accumulate_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/chunked_gemm.cu",
        replaces="src/repro/kernels/chunked_gemm.py:84",
        max_abs_err=err,
        ms=timer(lambda: accumulate_matmul(c, panel, w)),
        plain_ms=timer(lambda: ref.accumulate_matmul_ref(c, panel, w)),
        bound_ms=bound, bound_by=by, library_ms=library,
    )
    print(f"[kernels] K2 path shape {GROUP}x{rows}x{k_c}x{n_local}, C f32, "
          f"bf16 operands: max_abs_err {err:.3e}, {rec['ms']:.4f} ms (plain "
          f"{rec['plain_ms']:.4f}, torch.baddbmm(out_dtype=float32) "
          f"{library}, bound {bound:.4f} {by})")
    return rec


def phase_fused(device, timer):
    """K4 vs its plain version at multidev_kernels_driver.py's shapes and
    the main path's; its variants bit for bit; returns its record."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ficco_ag_matmul import ficco_ag_matmul_fused
    from repro_torch.parallel.collectives import all_gather
    from repro_torch.parallel.sharding import TPGroup, shard_columns
    from repro_torch.tune.variants import default_variant

    randn = _randn_fn(device, 3)
    # tests/multidev_kernels_driver.py's per-rank shards (m_s, K, n_local).
    for m_s, k, n_local, dtype in [(64, 128, 128, torch.float32),
                                   (32, 256, 128, torch.bfloat16)]:
        x = randn(GROUP, m_s, k, dtype=dtype)
        w = shard_columns(randn(k, GROUP * n_local, dtype=dtype), GROUP)
        got = ficco_ag_matmul_fused(x, w)
        _sync()
        tol = TOL[str(dtype).split(".")[1]]
        torch.testing.assert_close(got, ref.ag_matmul_ref(x, w), rtol=tol,
                                   atol=tol)
    print("[kernels] K4 ficco_ag_matmul_fused matches ag_matmul_ref at "
          "multidev_kernels_driver.py's shards 64x128x128 f32 (1e-5) and "
          "32x256x128 bf16 (2e-2), 4 ranks")

    m_s, n_local = PREFILL_BATCH * PREFILL_SEQ // GROUP, D_FF // GROUP
    x = randn(GROUP, m_s, D_MODEL, dtype=torch.bfloat16)
    w = shard_columns(
        randn(D_MODEL, D_FF, dtype=torch.bfloat16, scale=D_MODEL ** -0.5),
        GROUP,
    )
    got = ficco_ag_matmul_fused(x, w)
    want = ref.ag_matmul_ref(x, w)
    _sync()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    err = _max_err(got, want)
    base = default_variant("ficco_ag_matmul", group=GROUP)
    variants = [
        dataclasses.replace(base, chunks=c, buffer_depth=d, dispatch_order=o)
        for c in (2, 4) for d in (2, 3) for o in ("forward", "reverse")
    ]
    for v in variants:
        if not torch.equal(ficco_ag_matmul_fused(x, w, variant=v), got):
            raise AssertionError(f"K4 variant {v} is not bit-equal to the "
                                 "default")
    print(f"[kernels] K4 path shape: {len(variants)} variants (chunks 2/4, "
          "depth 2/3, forward/reverse) bit-equal to the default")

    flops = 2 * GROUP * (GROUP * m_s) * D_MODEL * n_local
    bound, by = _bound(flops, _nbytes(x, w, got), x.dtype)
    group = TPGroup(GROUP, device)
    rec = dict(
        name="ficco_ag_matmul_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/ficco_ag_matmul.cu",
        replaces="src/repro/kernels/ficco_ag_matmul.py:163",
        max_abs_err=err,
        ms=timer(lambda: ficco_ag_matmul_fused(x, w)),
        plain_ms=timer(lambda: ref.ag_matmul_ref(x, w)),
        bound_ms=bound, bound_by=by,
        # One call: the gathered rows as one (g*m_s, K) matrix broadcast
        # against every rank's weight shard.
        library_ms=timer(lambda: torch.matmul(x.view(-1, D_MODEL), w)),
    )
    composer = timer(lambda: ops.ag_matmul_dma(x, w, group=group))
    serial = timer(lambda: torch.matmul(all_gather(x, tiled=True), w))
    print(f"[kernels] K4 path shape {GROUP}x{m_s}x{D_MODEL}x{n_local} bf16: "
          f"max_abs_err {err:.3e}, {rec['ms']:.4f} ms (plain "
          f"{rec['plain_ms']:.4f}, torch.matmul {rec['library_ms']:.4f}, "
          f"bound {bound:.4f} {by}); K3+K1 composer {composer:.4f} ms, "
          f"all-gather + torch.matmul {serial:.4f} ms")
    return rec


def phase_schedules(device, timer):
    """The six schedules through ficco_linear at the main path's
    projection; what ``auto`` picks on the H100 model."""
    import torch

    from repro_torch.core.heuristics import (
        DEFAULT_SERIAL_GATE,
        serial_gate_score,
    )
    from repro_torch.core.machine import H100_SXM, machine_for_group
    from repro_torch.core.schedule_types import Schedule
    from repro_torch.core.workload import GemmShape
    from repro_torch.overlap.api import ficco_linear, resolve_schedule
    from repro_torch.parallel.sharding import shard_columns

    randn = _randn_fn(device, 4)
    m_s = PREFILL_BATCH * PREFILL_SEQ // GROUP
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        x = randn(GROUP, m_s, D_MODEL, dtype=dtype)
        w = shard_columns(
            randn(D_MODEL, D_FF, dtype=dtype, scale=D_MODEL ** -0.5), GROUP
        )
        want = torch.matmul(x.view(-1, D_MODEL), w)  # x_full @ w
        errs, times = {}, {}
        for sched in Schedule:
            got = ficco_linear(x, w, schedule=sched.value)
            _sync()
            torch.testing.assert_close(
                got, want, rtol=tol, atol=tol,
                msg=lambda m, s=sched: f"{s.value} {dtype}: {m}",
            )
            errs[sched.value] = _max_err(got, want)
            if dtype == torch.bfloat16:
                times[sched.value] = timer(
                    lambda s=sched: ficco_linear(x, w, schedule=s.value)
                )
        print(f"[schedules] {GROUP} ranks x ({m_s} x {D_MODEL}) @ "
              f"({D_MODEL} x {D_FF // GROUP}) {dtype}: all 6 match x_full @ w "
              f"(tol {tol}); max_abs_err "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if times:
            print("[schedules] device ms per call, bf16: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    m = GROUP * m_s
    picked = resolve_schedule("auto", m=m, n=D_FF, k=D_MODEL, group=GROUP)
    score = serial_gate_score(GemmShape(m, D_FF, D_MODEL, 2),
                              machine_for_group(H100_SXM, GROUP))
    print(f"[schedules] auto on {H100_SXM.name} (group {GROUP}) at M {m}, "
          f"N {D_FF}, K {D_MODEL}, bf16 -> {picked.value} (serial-gate score "
          f"{score:.3f}; above {DEFAULT_SERIAL_GATE} stays serial)")


def phase_prefill(device):
    """Full-width TinyLlama-1.1B prefill on the DMA path and on the 2D
    schedule; launch counts around each.  Returns the counts of the kernels
    each path runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OverlapConfig
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import TPGroup, tp_group
    from repro_torch.serve.engine import make_prefill

    cfg = dataclasses.replace(
        get_config("tinyllama-1.1b"),
        overlap=OverlapConfig(mode="uniform-fused-1d", backend="dma"),
    )
    model = build_model(cfg)
    t0 = time.time()
    state = model.init(0, device=device)
    _sync()
    n_params = sum(
        t.numel() for t in _leaves(state)
    )
    print(f"[prefill] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}; {n_params / 1e9:.3f}B "
          f"random weights (seed 0) in {time.time() - t0:.1f}s")
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ),
                           generator=gen, device=device)
    batch = {"tokens": tokens}
    prefill = make_prefill(model)
    prefill_2d = make_prefill(build_model(dataclasses.replace(
        cfg, overlap=OverlapConfig(mode="uniform-fused-2d",
                                   backend="collective"),
    )))
    group = TPGroup(GROUP, device)
    # Default variant: one chunk (1D) or one K slice (2D) per rank, so
    # every up/gate projection of every layer runs GROUP steps.
    per_path = cfg.num_layers * 2 * GROUP
    paths = {
        "DMA path": (prefill, {"chunked_matmul": per_path,
                               "a2a_chunk_exchange": per_path}),
        "2D path": (prefill_2d, {"accumulate_matmul": per_path}),
    }

    with torch.no_grad():
        dense = prefill(state, batch)  # no group: the dense projections
        _sync()
    scale = dense.float().abs().max().item()
    launches = {}
    for label, (run, expected) in paths.items():
        with torch.no_grad():
            ops.reset_launch_counts()
            with tp_group(group):
                logits = run(state, batch)
            _sync()
            counts = ops.launch_counts()
        want = {name: expected.get(name, 0) for name in counts}
        print(f"[prefill] {label}: launches in one prefill {counts} "
              f"(expected {want}: {cfg.num_layers} layers x 2 projections "
              f"x {GROUP} steps)")
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{want}")
        launches.update({name: counts[name] for name in expected})
        want_shape = (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab_size)
        if (tuple(logits.shape) != want_shape
                or not torch.isfinite(logits).all()):
            raise AssertionError(f"{label}: logits {tuple(logits.shape)} not "
                                 f"finite or not {want_shape}")
        err = _max_err(logits, dense)
        agree = (logits.argmax(-1) == dense.argmax(-1)).float().mean().item()
        print(f"[prefill] {label} logits vs dense forward: max_abs_err "
              f"{err:.4e} (max |logit| {scale:.4f}, ratio {err / scale:.3e}),"
              f" argmax agreement {agree:.4f}")
        # The paths differ from dense only in the up/gate GEMMs' summation
        # order (and, on the 2D path, in one rounding to bf16 of an fp32
        # sum where dense rounds once too); 22 residual layers carry a
        # one-ulp (2^-8) difference forward.
        if err > 5e-2 * scale:
            raise AssertionError(f"{label}: prefill logits differ from dense "
                                 f"by {err}")

    with torch.no_grad():
        def in_group(run):
            def go():
                with tp_group(group):
                    run(state, batch)
            return go

        def run_dense():
            prefill(state, batch)

        tokens_n = PREFILL_BATCH * PREFILL_SEQ
        timed = [("DMA path", in_group(prefill)),
                 ("2D path", in_group(prefill_2d)), ("dense", run_dense)]
        for name, fn in timed * 2:
            ms = wall_ms(fn)
            print(f"[prefill] {PREFILL_BATCH}x{PREFILL_SEQ} tokens, {name}: "
                  f"{ms:.2f} ms wall ({tokens_n / ms * 1e3:.0f} tok/s)")
        phase_trace("DMA-path prefill", in_group(prefill))
        phase_trace("2D-path prefill", in_group(prefill_2d))
    return cfg, model, state, launches


def phase_fused_path(device, cfg, state):
    """K4 over the model's up/gate projections through
    ``ops.ag_matmul_fused``, with the counts read around it; returns them.

    The prefill does not reach K4 (the reference's model path does not
    either): this is the fused AG->GEMM entry point driven over one
    prefill's worth of projection sites, one random activation shard.
    """
    import torch

    from repro_torch.kernels import ops
    from repro_torch.overlap.api import ficco_linear
    from repro_torch.parallel.sharding import shard_columns

    randn = _randn_fn(device, 5)
    x = randn(GROUP, PREFILL_BATCH * PREFILL_SEQ // GROUP, cfg.d_model,
              dtype=torch.bfloat16)
    ffn = state["layers"][0]["ffn"]
    weights = [shard_columns(ffn[name][i], GROUP)
               for i in range(cfg.num_layers) for name in ("w_up", "w_gate")]
    with torch.no_grad():
        ops.reset_launch_counts()
        outs = [ops.ag_matmul_fused(x, w) for w in weights]
        _sync()
        counts = ops.launch_counts()
    want = {name: len(weights) if name == "ficco_ag_matmul_fused" else 0
            for name in counts}
    print(f"[fused] K4 over {len(weights)} up/gate projections: launches "
          f"{counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"fused path: launches {counts}, expected {want}")
    err = 0.0
    for out, w in zip(outs, weights):
        serial = ficco_linear(x, w, schedule="serial")
        torch.testing.assert_close(out, serial, rtol=2e-2, atol=2e-2)
        err = max(err, _max_err(out, serial))
    print(f"[fused] every output matches the serial schedule (2e-2); max_abs"
          f"_err {err:.3e}")
    return {"ficco_ag_matmul_fused": counts["ficco_ag_matmul_fused"]}


def _union(intervals):
    """Merged, sorted [(start, end)] of possibly overlapping intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap(xs, ys) -> float:
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def phase_trace(label, run):
    """``run`` under torch.profiler: device time by kind, the device's idle
    share over the window, and how much of the copies' time ran under
    kernels (chunked_gemm.cu's and any)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        run()
        torch.cuda.synchronize()
    kernels, k1, copies, window = [], [], [], []
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        window += [start, end]
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "memcpy" in ev.name.lower():
            copies.append((start, end))
        else:
            kernels.append((start, end))
            if "chunked_gemm" in ev.name:
                k1.append((start, end))
    if not kernels:
        print("[trace] torch.profiler recorded no device events")
        return
    span = max(window) - min(window)
    k_union, k1_union, c_union = _union(kernels), _union(k1), _union(copies)
    busy_us = sum(b - a for a, b in _union(k_union + c_union))

    def total(merged):
        return sum(b - a for a, b in merged) / 1e3

    print(f"[trace] {label} (profiled): window {span / 1e3:.2f} ms,"
          f" device busy {busy_us / 1e3:.2f} ms (idle share "
          f"{1 - busy_us / span:.3f}); {len(k1)} chunked_gemm.cu (K1/K2) "
          f"kernels "
          f"{total(k1_union):.2f} ms; other kernels "
          f"{total(k_union) - total(k1_union):.2f} ms; {len(copies)} memcpy "
          f"events {total(c_union):.2f} ms, of which "
          f"{_overlap(c_union, k1_union) / 1e3:.2f} ms under K1/K2 and "
          f"{_overlap(c_union, k_union) / 1e3:.2f} ms under any kernel")
    names = sorted({ev.name for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and "memcpy" in ev.name.lower()})
    print(f"[trace] copy event names: {names}")


def phase_serve(device, cfg, model, state):
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.engine import DecodeEngine, Request

    prompts, prompt_len, new_tokens, cache_len = 4, 8, 16, 128
    rng = np.random.default_rng(0)
    raw = rng.integers(0, cfg.vocab_size, (prompts, prompt_len))
    with torch.no_grad():
        # The decode path against the prefill forward on the same prompts.
        cache = model.init_cache(prompts, cache_len, device=device)
        toks = torch.as_tensor(raw, device=device)
        steps = []
        for pos in range(prompt_len):
            lg, cache = model.decode_step(state, cache, toks[:, pos:pos + 1],
                                          pos)
            steps.append(lg)
        decoded = torch.cat(steps, dim=1)
        full, _ = model.forward(state, {"tokens": toks})
        err = _max_err(decoded, full)
        scale = full.float().abs().max().item()
    print(f"[serve] cached decode vs forward over {prompts}x{prompt_len} "
          f"prompt tokens: max_abs_err {err:.4e} (max |logit| {scale:.4f})")
    if not torch.isfinite(decoded).all() or err > 5e-2 * scale:
        raise AssertionError(f"decode logits differ from forward by {err}")

    def answer():
        eng = DecodeEngine(cfg, state, batch_size=prompts,
                           cache_len=cache_len, device=device)
        reqs = [Request(raw[i].astype(np.int32), max_new_tokens=new_tokens)
                for i in range(prompts)]
        t0 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, first = answer()  # the first run pays one-time library set-up
    ops.reset_launch_counts()
    out, dt = answer()
    total = sum(len(r.out) for r in out)
    if total != prompts * new_tokens or not all(
        r.done and all(0 <= t < cfg.vocab_size for t in r.out) for r in out
    ):
        raise AssertionError("DecodeEngine did not answer every request")
    print(f"[serve] DecodeEngine: {prompts} requests x {new_tokens} new "
          f"tokens (prompt {prompt_len}, cache {cache_len}): {total} tokens "
          f"in {dt:.3f}s, {total / dt:.1f} tok/s (first run {first:.3f}s); "
          f"kernel launches "
          f"{ops.launch_counts()} (decode feeds S=1, where the TP overlap "
          f"does not apply)")
    print(f"[serve] req0: {[int(t) for t in out[0].prompt]} -> {out[0].out}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    phase_build()
    timer = Timer(device)
    k1, k3 = phase_kernels(device, timer)
    kernels = [k1, phase_accumulate(device, timer), k3,
               phase_fused(device, timer)]
    phase_schedules(device, timer)
    cfg, model, state, launches = phase_prefill(device)
    launches.update(phase_fused_path(device, cfg, state))
    for k in kernels:
        k["launches"] = launches[k["name"]]
    phase_serve(device, cfg, model, state)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
