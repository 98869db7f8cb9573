#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit; build the CUDA kernels (one nvcc per
     source, in parallel) and print the build time;
  2. every kernel (K1-K4) against its plain PyTorch version on the card, at
     the reference's test shapes, at the shapes of the main path and, for
     K1, K2 and K4 on the wgmma route, at edge shapes, with CUDA-event
     timings beside the plain version's and one PyTorch call's; K3 on both
     its routes (one 2D copy per receiver, one copy per pair), bit for bit,
     timed by copy-stream count, with the host wall per call and a trace
     that shows its work as copies and no kernels; K4's variants bit for
     bit against each other, and the route each launch took;
  3. the six FiCCO schedules through ``ficco_linear`` at the main path's
     projection shape, in bf16 and f32, against ``x_full @ w``, and what
     ``auto`` resolves to on the H100 machine model; then the port's
     analytic core (``repro_torch.core``, NumPy on the host, no kernel):
     the design-space grid of Table I on the H100, MI300X and TPU v5e
     models through the scalar and the batched engine, bit for bit, and
     the simulator's time for each schedule at the projection beside the
     time the card took for it;
  4. the main paths: full-width TinyLlama-1.1B prefill (4 prompts x 512
     tokens) through ``make_prefill`` on a group of 4 logical ranks, once
     with the DMA-backend uniform-fused-1D TP MLP (K1 + K3) and once with
     the collective-backend uniform-fused-2D schedule (K2), each held
     against the dense forward, with the kernels' launch counts and routes
     (K1 and K2 on wgmma, K3 on strided) read around each; then the fused
     AG->GEMM (K4) over the same model's 44 up/gate projections through
     ``ops.ag_matmul_fused``, counted the same way (every one on wgmma);
  5. the runtime tuner (``repro_torch.autotune``, in a cache directory of
     its own): the measured tier times the six schedules at the
     projection with CUDA events and records the fastest; the variant
     searches of the K3 + K1 composer and of K4 time every feasible
     variant and promote the fastest; the full-width prefill under
     ``ficco_autotune`` (every projection resolved by the tuner, none by
     the fallback) against dense; the DMA-path prefill on the promoted
     variant, with the launch counts that variant implies;
  6. serving: ``DecodeEngine`` answers 4 requests on the same weights;
  7. training: full-width TinyLlama-1.1B train steps (4 x 512 tokens of
     ``SyntheticLM``, AdamW) through ``make_train_step`` on the group of 4,
     on the uniform-fused-2D schedule (K2 forward under its autograd
     Function; each period recomputed in the backward, as the config's
     ``remat`` asks, so 352 launches per step, all on wgmma) and dense,
     interleaved:
     every gradient finite, the up/gate gradients nonzero in every layer
     and held against dense with the loss and the gradient norm, the
     parameters moved, the DMA backend refused under grad; step wall
     times, tokens/s, the loss trajectory, peak memory and one profiled
     2D step;
  8. the design-space grid engine on the card (``[grid]``): the ``"torch"``
     engine over a dense grid of 1e5 synthetic scenarios and a ragged
     one of 2e4, each times the machine grid, held against the
     ``"numpy"`` engine on the host (valid totals within 1e-9 relative,
     the same best schedule wherever the top two are not tied), with
     points per second on each; ``calibrate_tau`` on the card against
     its scan-and-bisect reference (5%); the analytic tier's pick
     latency at the projection on either backend;
  9. the machine fit (``[fit]``): ``fit_machine`` on the card recovers a
     perturbed ``H100_SXM`` (5%), then fits ``H100_SXM``'s link constants
     to the times ``Autotuner.measure`` records at four sizes of the
     projection (loss no worse than before, the result persisted and
     read back, not deployed);
 10. the learned gate (``[gate]``): statistics from a reduce-mode sweep on
     the ``"torch"`` engine, a trained gate held to the reference's
     accuracy thresholds on its held-out grids, installed with
     ``Autotuner.set_gate`` and read back from a pick's decision record,
     and the ``"measured"`` engine's shortlist ranking from [fit]'s
     records;
 11. the MoE family (``[moe]``), once TinyLlama's state is freed:
     DeepSeek-V2-Lite-16B whole at full width (27 MoE layers of 64 experts
     top-6 and 2 shared, MLA), its parameter bytes and memory; a 4 x 512
     prefill dense and on the DMA path on the group of 4 (the shared
     experts' up/gate projections: K3, 216 launches), timed in turns
     beside the bound, one profiled run each, the logits held against
     dense (5 %) with the share of expert choices that differ; cached
     decode through the MLA latent cache against the forward (5 %, on
     the forward's expert choices; the free-running decode printed); the
     ``DecodeEngine`` per step beside its byte bound; and the
     expert-parallel dispatch at the model's MoE layer
     (``serial_a2a_ffn``, ``ficco_a2a_ffn``'s variants) against each
     other, each timed with CUDA events beside its bound;
then one JSON line listing the kernels and, last, the result line.
With no CUDA device, or without the repository's ``src/repro_torch`` beside
it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor cores,
# fp32 outside the tensor cores, HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

PREFILL_BATCH, PREFILL_SEQ, GROUP = 4, 512, 4
# The training phase: a batch of 4 x 512 tokens, one warm-up step and
# TRAIN_STEPS timed steps on each path.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 4
# TinyLlama-1.1B's widths: the main path's projection is (4 * 512 tokens,
# D_MODEL) @ (D_MODEL, D_FF), column-sharded over GROUP ranks.
D_MODEL, D_FF = 2048, 5632
REPS = 20
# The reference's tolerances (tests/test_kernels.py, tests/multidev_*.py).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# What [done] counts: every phase the script prints, in order.
PHASES = ("build", "kernels", "schedules", "design", "prefill", "fused",
          "autotune", "serve", "train", "grid", "fit", "gate", "moe")


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


def issue_ms(fn, reps: int = REPS) -> float:
    """Host time to enqueue one call of ``fn``, the mean over ``reps``
    calls queued while a spin kernel holds the stream (so the device's
    work is not waited for)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(Timer.SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _expect_routes(what, kernel, **want):
    """Raise unless ``kernel.routes`` holds exactly ``want`` launches per
    route (0 for a route not named); then set them to 0."""
    got = dict(kernel.routes)
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        raise AssertionError(f"{what}: launches by route {got}, expected "
                             f"{full}")
    kernel.routes = dict.fromkeys(got, 0)


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


def _card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch.kernels import _build

    print(_card())
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
    from repro_torch.kernels.dma_exchange import ficco_uniform_fused_1d_dma
    from repro_torch.parallel.sharding import TPGroup, shard_columns
    from repro_torch.tune.variants import KernelVariant

    randn = _randn_fn(device, 0)

    # K1 at the reference's tests/test_kernels.py shapes and tolerances:
    # f32 on the CUDA cores, bf16 on the wgmma route.
    ops.reset_launch_counts()
    for m, n, k in [(128, 128, 128), (256, 128, 384), (384, 256, 128),
                    (128, 384, 256)]:
        for dtype, tol in [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]:
            x, w = randn(m, k, dtype=dtype), randn(k, n, dtype=dtype)
            got = chunked_matmul(x, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref.matmul_ref(x, w),
                                       rtol=tol, atol=tol)
    _expect_routes("K1 at the test_kernels shapes", chunked_matmul,
                   simt=4, wgmma=4)
    # bf16 edges of the wgmma route: M and N not multiples of 128, K not a
    # multiple of 64 (and under 64), and more tiles than the card has SMs
    # (4 ranks x 8 x 8 tiles of 128 x 128).
    edges = [(1, 192, 320, 96), (1, 72, 136, 24), (1, 200, 328, 200),
             (GROUP, 1000, 1000, 1000)]
    for g, m, n, k in edges:
        x = randn(g, m, k, dtype=torch.bfloat16)
        w = randn(g, k, n, dtype=torch.bfloat16, scale=k ** -0.5)
        got = chunked_matmul(x, w, block_m=m, block_n=n, block_k=k)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.matmul_ref(x, w), rtol=2e-2,
                                   atol=2e-2, msg=lambda e: f"K1 {g}x{m}x"
                                   f"{n}x{k}: {e}")
    _expect_routes("K1 at the edge shapes", chunked_matmul, wgmma=len(edges))
    # bf16 rows of 60 bytes: no tensor-core route takes them.
    x, w = randn(100, 30, dtype=torch.bfloat16), randn(30, 60,
                                                       dtype=torch.bfloat16)
    got = chunked_matmul(x, w, block_m=100, block_n=60, block_k=30)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.matmul_ref(x, w), rtol=2e-2,
                               atol=2e-2)
    _expect_routes("K1 at 100x60x30 bf16", chunked_matmul, simt=1)
    print("[kernels] K1 chunked_matmul matches matmul_ref at the 4 "
          "test_kernels shapes, f32 (1e-4, simt) and bf16 (2e-2, wgmma), "
          "on the wgmma route at the bf16 edges "
          + ", ".join(f"{g}x{m}x{n}x{k}" for g, m, n, k in edges)
          + " (2e-2), and at 100x60x30 bf16 (simt, 2e-2)")

    # K1 at the main path's step GEMM: 4 ranks x (g*m_c=512, K=2048) @
    # (2048, n_local=1408), the weight a strided column-shard view.
    d_model, d_ff = D_MODEL, D_FF
    rows = PREFILL_BATCH * PREFILL_SEQ // GROUP  # g * m_c
    x = randn(GROUP, rows, d_model, dtype=torch.bfloat16)
    w = shard_columns(
        randn(d_model, d_ff, dtype=torch.bfloat16, scale=d_model ** -0.5),
        GROUP,
    )
    ops.reset_launch_counts()
    got = chunked_matmul(x, w, block_k=d_model)
    _expect_routes("K1 at the path shape", chunked_matmul, wgmma=1)
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
          f"bf16: max_abs_err {k1_err:.3e}, {k1['ms']:.4f} ms on wgmma "
          f"(plain {k1['plain_ms']:.4f}, torch.matmul "
          f"{k1['library_ms']:.4f}, bound {k1_bound:.4f} {k1_by})")

    k3 = phase_exchange(device, timer)

    # The composer at the main path's per-rank shard (m_s = 512 rows).
    group = TPGroup(GROUP, device)
    xs = randn(GROUP, rows, d_model, dtype=torch.bfloat16)
    fwd = ops.ag_matmul_dma(xs, w, group=group)
    rev_variant = KernelVariant(
        kernel="dma_exchange", chunks=GROUP, block_m=128, block_n=128,
        block_k=128, dispatch_order="reverse",
    )
    rev = ficco_uniform_fused_1d_dma(xs, w, variant=rev_variant,
                                     copy_streams=group.copy_streams)
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


def phase_exchange(device, timer):
    """K3 on both routes against its plain version, bit for bit; its time
    by copy-stream count; a trace of its work.  Returns its record."""
    import torch

    from repro_torch.kernels import dma_exchange, ops, ref
    from repro_torch.kernels.dma_exchange import a2a_chunk_exchange
    from repro_torch.parallel.sharding import COPY_STREAMS, TPGroup

    randn = _randn_fn(device, 1)
    k = a2a_chunk_exchange
    streams = TPGroup(GROUP, device).copy_streams[1:]
    m_c = PREFILL_BATCH * PREFILL_SEQ // GROUP // GROUP  # m_s / steps

    def operands(m, width, dtype):
        # Chunk 1 of the composer's x.reshape(g, steps, m_c, K), a step
        # buffer, and the same as one tensor per rank (the pairs route).
        x = randn(GROUP, GROUP * m, width, dtype=dtype)
        chunks = x.reshape(GROUP, GROUP, m, width)[:, 1]
        buf = torch.empty((GROUP, GROUP, m, width), dtype=dtype,
                          device=device)
        return (chunks, buf, [c.clone() for c in chunks],
                [torch.empty_like(b) for b in buf])

    # At the path's chunk (m_c x K bf16) and an odd f32 shape, both routes,
    # forward and reverse, over the group's copy streams.
    ops.reset_launch_counts()
    shapes = [(m_c, D_MODEL, torch.bfloat16), (37, 129, torch.float32)]
    k3_err = 0.0
    for m, width, dtype in shapes:
        chunks, buf, chunk_list, buf_list = operands(m, width, dtype)
        want = ref.a2a_chunk_exchange_ref(chunks)
        for reverse in (False, True):
            for route, got in [
                ("strided", lambda: k(chunks, reverse=reverse, out=buf,
                                      streams=streams)),
                ("pairs", lambda: torch.stack(k(chunk_list, reverse=reverse,
                                                out=buf_list,
                                                streams=streams))),
            ]:
                buf.fill_(float("nan"))
                for b in buf_list:
                    b.fill_(float("nan"))
                out = got()
                _sync()
                k3_err = max(k3_err, _max_err(out, want))
                if not torch.equal(out, want):
                    raise AssertionError(
                        f"K3 {route} (reverse={reverse}) at {GROUP}x{m}x"
                        f"{width} {dtype} is not bit-equal to "
                        "a2a_chunk_exchange_ref")
    n_checks = len(shapes) * 2
    _expect_routes("K3 checks", k, strided=n_checks, pairs=n_checks)
    engines = dma_exchange.copy_engines()
    print(f"[kernels] K3 a2a_chunk_exchange bit-equal to its plain version "
          f"on both routes (strided, pairs), forward and reverse, at "
          f"{GROUP}x{m_c}x{D_MODEL} bf16 and {GROUP}x37x129 f32, over "
          f"{1 + len(streams)} copy streams; the card has {engines} copy "
          "engines (cudaDevAttrAsyncEngineCount)")

    # Time at the path's chunk: the strided route by copy-stream count
    # (device ms, and the host's ms to issue one call), the pairs route at
    # the group's, and the host wall per call of both.
    chunks, buf, chunk_list, buf_list = operands(m_c, D_MODEL, torch.bfloat16)
    by_streams, issue = {}, {}
    for n in range(1, GROUP + 1):
        side = [torch.cuda.Stream(device=device) for _ in range(n - 1)]
        by_streams[n] = timer(lambda: k(chunks, out=buf, streams=side))
        issue[n] = issue_ms(lambda: k(chunks, out=buf, streams=side))
    pairs_ms = timer(lambda: k(chunk_list, out=buf_list, streams=streams))
    pairs_issue = issue_ms(lambda: k(chunk_list, out=buf_list,
                                     streams=streams))
    strided_wall = wall_ms(lambda: k(chunks, out=buf, streams=streams), REPS)
    pairs_wall = wall_ms(lambda: k(chunk_list, out=buf_list,
                                   streams=streams), REPS)
    bound, by = _bound(0, _nbytes(chunks, buf), chunks.dtype)
    rec = dict(
        name="a2a_chunk_exchange", route="cuda",
        source="src/repro_torch/kernels/csrc/dma_exchange.cu",
        replaces="src/repro/kernels/dma_exchange.py:91",
        max_abs_err=k3_err,
        ms=by_streams[1 + len(streams)],
        plain_ms=timer(lambda: ref.a2a_chunk_exchange_ref(chunks, out=buf)),
        bound_ms=bound, bound_by=by,
        library_ms=timer(
            lambda: buf.copy_(chunks.unsqueeze(0).expand_as(buf))
        ),
    )
    print(f"[kernels] K3 path chunk {GROUP}x{m_c}x{D_MODEL} bf16: strided "
          f"route (one 2D copy per receiver) "
          + ", ".join(f"{v:.4f} ms on {n} stream{'s' * (n > 1)} (issue "
                      f"{issue[n]:.4f} ms)" for n, v in by_streams.items())
          + f" (the group's {1 + len(streams)}, COPY_STREAMS "
          f"{COPY_STREAMS}); pairs route ({GROUP * GROUP} copies) "
          f"{pairs_ms:.4f} ms (issue {pairs_issue:.4f} ms); host wall per "
          f"call strided "
          f"{strided_wall:.4f} ms, pairs {pairs_wall:.4f} ms (plain "
          f"{rec['plain_ms']:.4f}, broadcast copy_ {rec['library_ms']:.4f}, "
          f"bound {bound:.4f} {by})")

    calls = 8
    stats = phase_trace(
        f"{calls} K3 calls (strided)",
        lambda: [k(chunks, out=buf, streams=streams) for _ in range(calls)],
    )
    if stats["copies"] != calls * GROUP or stats["kernels"]:
        raise AssertionError(
            f"K3 trace: {stats['copies']} memcpy events and "
            f"{stats['kernels']} kernels for {calls} calls; expected "
            f"{calls * GROUP} copies (one per receiver) and no kernel")
    return rec


def phase_accumulate(device, timer):
    """K2 vs its plain version at the reference's shapes and the 2D
    schedule's step; returns its record."""
    import torch

    from repro_torch.kernels import ops, ref
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
    # f32 GEMM, 2e-2 bf16), one shape no tile divides and one of two row
    # blocks, in f32 and bf16 (simt) and as the 2D schedule's mix of an
    # fp32 C with bf16 operands (wgmma, but for 100x60x30's 60-byte rows).
    shapes = [(128, 128, 128), (256, 128, 384), (384, 256, 128),
              (128, 384, 256), (100, 60, 30), (192, 128, 64)]
    ops.reset_launch_counts()
    for m, n, k in shapes:
        for dtype, tol in [(f32, 1e-4), (bf16, 2e-2)]:
            check(randn(m, n, dtype=dtype), randn(m, k, dtype=dtype),
                  randn(k, n, dtype=dtype), tol, f"{m}x{n}x{k} {dtype}")
        check(randn(m, n, dtype=f32), randn(m, k, dtype=bf16),
              randn(k, n, dtype=bf16), 1e-4, f"{m}x{n}x{k} mixed")
    _expect_routes("K2 at the test_kernels shapes", accumulate_matmul,
                   simt=2 * len(shapes) + 1, wgmma=len(shapes) - 1)
    # The wgmma route at ragged aligned shapes: M, N and K not multiples
    # of the 128 x 128 x 64 tile, K under 64, and more tiles than SMs.
    edges = [(1, 200, 200, 72), (1, 72, 136, 24), (GROUP, 1000, 1000, 1000)]
    for g, m, n, k in edges:
        check(randn(g, m, n, dtype=f32), randn(g, m, k, dtype=bf16),
              randn(g, k, n, dtype=bf16), 1e-4, f"{g}x{m}x{n}x{k} mixed")
    _expect_routes("K2 at the edge shapes", accumulate_matmul,
                   wgmma=len(edges))
    print("[kernels] K2 accumulate_matmul matches accumulate_matmul_ref in "
          "place at the 4 test_kernels shapes, 100x60x30 and 192x128x64, "
          "f32 (1e-4) and bf16 (2e-2) on simt, f32 C with bf16 operands "
          "(1e-4) on wgmma (100x60x30 on simt); on wgmma at "
          + ", ".join(f"{g}x{m}x{n}x{k}" for g, m, n, k in edges)
          + " (1e-4)")

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
    _expect_routes("K2 at the path shape", accumulate_matmul, wgmma=1)
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
          f"bf16 operands: max_abs_err {err:.3e}, {rec['ms']:.4f} ms on wgmma "
          f"(plain "
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
    # tests/multidev_kernels_driver.py's per-rank shards (m_s, K, n_local):
    # f32 on simt, bf16 (a shard of 32 rows: a quarter-full tile) on wgmma;
    # then a bf16 edge on wgmma (m_s, K and n_local not multiples of the
    # tile) and a group over the wgmma route's cap on the wmma tile.
    cases = [(GROUP, 64, 128, 128, torch.float32, "simt"),
             (GROUP, 32, 256, 128, torch.bfloat16, "wgmma"),
             (GROUP, 200, 200, 136, torch.bfloat16, "wgmma"),
             (17, 34, 128, 128, torch.bfloat16, "wmma")]
    ops.reset_launch_counts()
    for g, m_s, k, n_local, dtype, route in cases:
        x = randn(g, m_s, k, dtype=dtype)
        w = shard_columns(randn(k, g * n_local, dtype=dtype, scale=k ** -0.5),
                          g)
        got = ficco_ag_matmul_fused(x, w)
        _sync()
        tol = TOL[str(dtype).split(".")[1]]
        torch.testing.assert_close(got, ref.ag_matmul_ref(x, w), rtol=tol,
                                   atol=tol, msg=lambda e: f"K4 {g}x{m_s}x"
                                   f"{k}x{n_local} {dtype}: {e}")
        _expect_routes(f"K4 {g}x{m_s}x{k}x{n_local}", ficco_ag_matmul_fused,
                       **{route: 1})
    print("[kernels] K4 ficco_ag_matmul_fused matches ag_matmul_ref at "
          "multidev_kernels_driver.py's shards 64x128x128 f32 (1e-5, simt) "
          "and 32x256x128 bf16 (2e-2, wgmma), 4 ranks; at 200x200x136 bf16 "
          "(wgmma) and, over the wgmma cap, 17 ranks of 34x128x128 bf16 "
          "(wmma)")

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
    ficco_ag_matmul_fused.routes = dict.fromkeys(ficco_ag_matmul_fused.routes,
                                                 0)
    for v in variants:
        if not torch.equal(ficco_ag_matmul_fused(x, w, variant=v), got):
            raise AssertionError(f"K4 variant {v} is not bit-equal to the "
                                 "default")
    _expect_routes("K4 variants", ficco_ag_matmul_fused, wgmma=len(variants))
    print(f"[kernels] K4 path shape: {len(variants)} variants (chunks 2/4, "
          "depth 2/3, forward/reverse) bit-equal to the default, all on "
          "wgmma")

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
          f"max_abs_err {err:.3e}, {rec['ms']:.4f} ms on wgmma (plain "
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
            bf16_times = times
    m = GROUP * m_s
    picked = resolve_schedule("auto", m=m, n=D_FF, k=D_MODEL, group=GROUP)
    score = serial_gate_score(GemmShape(m, D_FF, D_MODEL, 2),
                              machine_for_group(H100_SXM, GROUP))
    print(f"[schedules] auto on {H100_SXM.name} (group {GROUP}) at M {m}, "
          f"N {D_FF}, K {D_MODEL}, bf16 -> {picked.value} (serial-gate score "
          f"{score:.3f}; above {DEFAULT_SERIAL_GATE} stays serial)")
    return bf16_times, picked


def phase_design(measured, auto):
    """The port's analytic core in this process: Table I on three machine
    models through both grid engines (bit for bit), and the simulator's
    time for each schedule at the main path's projection beside
    ``measured`` (device ms per schedule from [schedules]).  The predicted
    times are model outputs from data-sheet constants, and the logical
    group's exchange on one card is device-memory copies, not the
    machine model's NVLink: nothing here is held against the card."""
    import numpy as np

    from repro_torch.core import (
        H100_SXM,
        MI300X,
        TABLE_I,
        TPU_V5E,
        GemmShape,
        best_schedule,
        explore_grid,
        machine_for_group,
    )

    machines = [H100_SXM, MI300X, TPU_V5E]
    t0 = time.perf_counter()
    ex = {b: explore_grid(TABLE_I, machines=machines, backend=b)
          for b in ("scalar", "numpy")}
    dt = (time.perf_counter() - t0) * 1e3
    scalar, batched = ex["scalar"].grid, ex["numpy"].grid
    if not (np.array_equal(scalar.total, batched.total, equal_nan=True)
            and np.array_equal(scalar.valid, batched.valid)):
        raise AssertionError("[design] the scalar and numpy engines' "
                             "GridResult.total differ")
    for name, e in ex.items():
        print(f"[design] explore_grid(TABLE_I, {[m.name for m in machines]})"
              f" on {name}: {e.summary()}")
    print(f"[design] scalar and numpy GridResult.total bit-equal over "
          f"{scalar.total.size} (schedule x scenario x machine) entries "
          f"({dt:.1f} ms for both)")
    machine = machine_for_group(H100_SXM, GROUP)
    gemm = GemmShape(PREFILL_BATCH * PREFILL_SEQ, D_FF, D_MODEL, 2)
    best, results = best_schedule(gemm, machine)
    print(f"[design] {machine.name} at group {GROUP}, M {gemm.m}, N {gemm.n},"
          f" K {gemm.k}, bf16: predicted ms (model output, data-sheet "
          "constants) vs measured device ms on this card: "
          + ", ".join(f"{s.value} {r.total * 1e3:.4f} vs "
                      f"{measured[s.value]:.4f}"
                      for s, r in results.items()))
    print(f"[design] best_schedule -> {best.value}, auto -> {auto.value}")
    return {s.value: r.total for s, r in results.items()}


def _dma_launches(variant, n_sites):
    """K1 and K3 launches of ``n_sites`` DMA-path projections at the main
    path's shard on ``variant``, by the composer's rule: one exchange per
    step (the variant's chunks, or one per rank where they do not cut the
    shard), and K1 per step only where the variant's M x N tile divides
    the step GEMM (else ``torch.matmul``)."""
    m_s, n_local = PREFILL_BATCH * PREFILL_SEQ // GROUP, D_FF // GROUP
    steps = variant.chunks if m_s % variant.chunks == 0 else GROUP
    rows = GROUP * (m_s // steps)
    blocked = (rows % variant.block_m == 0
               and n_local % variant.block_n == 0
               and (variant.block_m < rows or variant.block_n < n_local))
    return {"chunked_matmul": n_sites * steps if blocked else 0,
            "a2a_chunk_exchange": n_sites * steps}


def phase_autotune(device, timer, cfg, state, measured, design):
    """The port's runtime tuner on the card, in a cache directory of its
    own; promotions and the tuner are dropped on the way out.  ``measured``
    and ``design`` are [schedules]' device ms and [design]'s model seconds
    per schedule."""
    from repro_torch.autotune import reset_tuner
    from repro_torch.tune import registry

    outer = os.environ["REPRO_AUTOTUNE_CACHE_DIR"]
    with tempfile.TemporaryDirectory(prefix="autotune-") as cache_dir:
        os.environ["REPRO_AUTOTUNE_CACHE_DIR"] = cache_dir
        reset_tuner()
        registry.reset_variants()
        try:
            _autotune(device, timer, cfg, state, measured, design)
        finally:
            registry.reset_variants()
            reset_tuner()
            os.environ["REPRO_AUTOTUNE_CACHE_DIR"] = outer


def _autotune(device, timer, cfg, state, measured, design):
    """(a) the measured tier over the six schedules at the main path's
    projection; (b)-(c) the variant searches of the K3 + K1 composer and
    of K4, timed with :class:`Timer`; (d) the full-width prefill under
    ``ficco_autotune``; (e) the DMA-path prefill on the promoted variant,
    with the launch counts that variant implies."""
    import torch

    from repro_torch.autotune import get_tuner
    from repro_torch.configs.base import OverlapConfig
    from repro_torch.core.machine import H100_SXM
    from repro_torch.core.schedule_types import Schedule
    from repro_torch.core.workload import GemmShape
    from repro_torch.kernels import ops
    from repro_torch.kernels.dma_exchange import ficco_uniform_fused_1d_dma
    from repro_torch.kernels.ficco_ag_matmul import ficco_ag_matmul_fused
    from repro_torch.models.model import build_model
    from repro_torch.obs import metrics
    from repro_torch.parallel.sharding import TPGroup, shard_columns, tp_group
    from repro_torch.serve.engine import make_prefill
    from repro_torch.tune import registry, search_kernel_variants

    randn = _randn_fn(device, 6)
    m_s = PREFILL_BATCH * PREFILL_SEQ // GROUP
    x = randn(GROUP, m_s, D_MODEL, dtype=torch.bfloat16)
    w = shard_columns(
        randn(D_MODEL, D_FF, dtype=torch.bfloat16, scale=D_MODEL ** -0.5),
        GROUP,
    )
    gemm = GemmShape(GROUP * m_s, D_FF, D_MODEL, 2)
    tuner = get_tuner()
    print(f"[autotune] tuner: backend {tuner.backend}, cache "
          f"{tuner.cache.path}")

    # (a) The measured tier: every schedule, once to warm up, then 3 runs
    # between CUDA events, the fastest kept.
    t0 = time.perf_counter()
    dec = tuner.measure(x, w, schedules=list(Schedule), iters=3)
    took = time.perf_counter() - t0
    times = dict(dec.shortlist)
    print(f"[autotune] (a) measure at {dec.key} in {took:.2f}s host: "
          f"tuner ms (min of 3, CUDA events, no L2 flush) vs [schedules] "
          f"ms (median of {REPS}, cold L2) vs [design] model ms: "
          + ", ".join(f"{s.value} {times[s.value] * 1e3:.4f} vs "
                      f"{measured[s.value]:.4f} vs "
                      f"{design[s.value] * 1e3:.4f}" for s in Schedule)
          + f" -> {dec.schedule.value} ({dec.source})")
    if dec.source != "measured" or len(times) != len(Schedule) or not all(
            math.isfinite(t) and t > 0 for t in times.values()):
        raise AssertionError(f"[autotune] measure: {dec}")
    again = tuner.pick(gemm, H100_SXM, group=GROUP)
    if (again.source, again.schedule) != ("cache", dec.schedule):
        raise AssertionError(f"[autotune] pick after measure: {again}")
    print(f"[autotune] (a) pick at the same key -> {again.schedule.value} "
          f"({again.source})")

    # (b), (c) The variant searches, each variant timed as the [kernels]
    # phase times a kernel (median device ms, cold L2).
    group = TPGroup(GROUP, device)
    runs = {
        "dma_exchange": lambda v: ficco_uniform_fused_1d_dma(
            x, w, variant=v, copy_streams=group.copy_streams),
        "ficco_ag_matmul": lambda v: ficco_ag_matmul_fused(x, w, variant=v),
    }
    for label, kernel in (("(b)", "dma_exchange"),
                          ("(c)", "ficco_ag_matmul")):
        res = search_kernel_variants(
            kernel, gemm, H100_SXM, group=GROUP,
            runner=lambda v, run=runs[kernel]: timer(lambda: run(v)) / 1e3,
        )
        reasons = {}
        for r in res.rejected:
            reasons[r.reason] = reasons.get(r.reason, 0) + 1
        print(f"[autotune] {label} {kernel}: {res.n_enumerated} enumerated, "
              f"{res.n_feasible} feasible, {len(res.rejected)} rejected "
              f"{reasons}; search {res.seconds:.2f}s host")
        print(f"[autotune] {label} {kernel} ms per variant: "
              + ", ".join(f"{v.digest()} {t * 1e3:.4f}"
                          for v, t in res.timings))
        print(f"[autotune] {label} {kernel}: winner {res.best.digest()} "
              f"{res.best_seconds * 1e3:.4f} ms, default "
              f"{res.default.digest()} {res.default_seconds * 1e3:.4f} ms, "
              f"speedup {res.speedup:.4f}")
        records = {k: e for k, e in tuner.cache.entries.items()
                   if e.get("kernel") == kernel and "/v" in k}
        if (len(records) != res.n_feasible
                or {e["source"] for e in records.values()} != {"measured"}
                or res.default not in dict(res.timings)):
            raise AssertionError(
                f"[autotune] {kernel}: {len(records)} records, sources "
                f"{ {e['source'] for e in records.values()} }, default "
                f"{res.default.digest()} feasible: "
                f"{res.default in dict(res.timings)}")
        plain = tuner.cache.get(dec.key)
        print(f"[autotune] {label} the decision record at {dec.key} now: "
              f"{plain}")

    # (d) The full-width prefill with every up/gate projection resolved by
    # the tuner (the [prefill] phase's weights and prompts).
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (PREFILL_BATCH, PREFILL_SEQ),
                                     generator=gen, device=device)}
    sites = cfg.num_layers * 2

    def prefill_on(**overlap):
        return make_prefill(build_model(dataclasses.replace(
            cfg, overlap=OverlapConfig(**overlap))))

    with torch.no_grad():
        dense = prefill_on(mode="gspmd_serial")(state, batch)
        _sync()
        scale = dense.float().abs().max().item()

        def check(label, logits):
            err = _max_err(logits, dense)
            print(f"[autotune] {label} logits vs dense: max_abs_err "
                  f"{err:.4e} (max |logit| {scale:.4f}, ratio "
                  f"{err / scale:.3e})")
            if not torch.isfinite(logits).all() or err > 5e-2 * scale:
                raise AssertionError(f"[autotune] {label}: logits differ "
                                     f"from dense by {err}")

        tuned = prefill_on(mode="ficco_autotune", backend="collective")
        metrics.reset_metrics()
        ops.reset_launch_counts()
        with tp_group(group):
            logits = tuned(state, batch)
        _sync()
        counters = metrics.get_metrics().snapshot()["counters"]
        resolve = {k: v for k, v in counters.items()
                   if k.startswith("overlap/resolve.")}
        print(f"[autotune] (d) ficco_autotune prefill: {resolve}, "
              f"tuner_tier_rates {metrics.tuner_tier_rates()}, decisions "
              f"{counters.get('tuner/decisions', 0)}; launches "
              f"{ops.launch_counts()}")
        if (counters.get("overlap/resolve.autotune", 0) != sites
                or counters.get("overlap/resolve.autotune_fallback", 0)
                or counters.get("tuner/pick.heuristic", 0)):
            raise AssertionError(f"[autotune] (d) counters {counters}")
        check("(d) ficco_autotune prefill", logits)
        walls = {}
        for name, fn in [("ficco_autotune", tuned),
                         ("serial", prefill_on(mode="serial"))] * 2:
            def go(fn=fn):
                with tp_group(group):
                    fn(state, batch)
            walls.setdefault(name, []).append(wall_ms(go))
        print("[autotune] (d) prefill wall ms (median of 5, two turns): "
              + ", ".join(f"{k} " + " / ".join(f"{ms:.2f}" for ms in v)
                          for k, v in walls.items()))

        # (e) The DMA path with variant=None: the composer resolves the
        # variant (b) promoted.
        variant = registry.resolve_variant("dma_exchange", group=GROUP)
        ops.reset_launch_counts()
        with tp_group(group):
            logits = prefill_on(mode="uniform-fused-1d",
                                backend="dma")(state, batch)
        _sync()
        counts, routes = ops.launch_counts(), ops.route_counts()
        want = {name: 0 for name in counts}
        want.update(_dma_launches(variant, sites))
        want_routes = {
            name: {r: want[name] if r == PATH_ROUTES[name] else 0
                   for r in per_route}
            for name, per_route in routes.items()
        }
        print(f"[autotune] (e) DMA prefill on the promoted variant "
              f"{variant.digest()}: launches {counts} (expected {want}); "
              f"by route {routes}")
        if counts != want or routes != want_routes:
            raise AssertionError(f"[autotune] (e) launches {counts} by "
                                 f"route {routes}, expected {want} by route "
                                 f"{want_routes}")
        check("(e) promoted DMA prefill", logits)


# The route every main-path launch of each kernel must take.
PATH_ROUTES = {"chunked_matmul": "wgmma", "accumulate_matmul": "wgmma",
               "a2a_chunk_exchange": "strided",
               "ficco_ag_matmul_fused": "wgmma"}


def phase_prefill(device):
    """Full-width TinyLlama-1.1B prefill on the DMA path and on the 2D
    schedule; launch counts around each.  Returns the counts of the kernels
    each path runs, and their counts by route."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OverlapConfig
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import TPGroup, tp_group
    from repro_torch.serve.engine import make_prefill
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(
        get_config("tinyllama-1.1b"),
        overlap=OverlapConfig(mode="uniform-fused-1d", backend="dma"),
    )
    model = build_model(cfg)
    t0 = time.time()
    state = model.init(0, device=device)
    _sync()
    n_params = sum(t.numel() for t in leaves(state))
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
    launches, by_route = {}, {}
    for label, (run, expected) in paths.items():
        with torch.no_grad():
            ops.reset_launch_counts()
            with tp_group(group):
                logits = run(state, batch)
            _sync()
            counts = ops.launch_counts()
            routes = ops.route_counts()
        want = {name: expected.get(name, 0) for name in counts}
        # Every launch of the path on its kernel's PATH_ROUTES route.
        want_routes = {
            name: {r: expected.get(name, 0) if r == PATH_ROUTES[name] else 0
                   for r in per_route}
            for name, per_route in routes.items()
        }
        print(f"[prefill] {label}: launches in one prefill {counts} "
              f"(expected {want}: {cfg.num_layers} layers x 2 projections "
              f"x {GROUP} steps); by route {routes}")
        if counts != want or routes != want_routes:
            raise AssertionError(f"{label}: launches {counts} by route "
                                 f"{routes}, expected {want} by route "
                                 f"{want_routes}")
        launches.update({name: counts[name] for name in expected})
        by_route.update({name: routes[name] for name in expected})
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
        stats = phase_trace("DMA-path prefill", in_group(prefill))
        # K3's work runs as copies: one 2D copy per receiver and call.
        k3_copies = launches["a2a_chunk_exchange"] * GROUP
        if stats["copies"] < k3_copies:
            raise AssertionError(
                f"DMA-path trace: {stats['copies']} memcpy events, fewer "
                f"than K3's {k3_copies} copies")
        phase_trace("2D-path prefill", in_group(prefill_2d))
    return cfg, model, state, launches, by_route


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
        routes = ops.route_counts()["ficco_ag_matmul_fused"]
    want = {name: len(weights) if name == "ficco_ag_matmul_fused" else 0
            for name in counts}
    want_routes = {r: len(weights) if r == "wgmma" else 0 for r in routes}
    print(f"[fused] K4 over {len(weights)} up/gate projections: launches "
          f"{counts} (expected {want}); K4 by route {routes}")
    if counts != want or routes != want_routes:
        raise AssertionError(f"fused path: launches {counts}, K4 by route "
                             f"{routes}, expected {want} and {want_routes}")
    err = 0.0
    for out, w in zip(outs, weights):
        serial = ficco_linear(x, w, schedule="serial")
        torch.testing.assert_close(out, serial, rtol=2e-2, atol=2e-2)
        err = max(err, _max_err(out, serial))
    print(f"[fused] every output matches the serial schedule (2e-2); max_abs"
          f"_err {err:.3e}")
    return ({"ficco_ag_matmul_fused": counts["ficco_ag_matmul_fused"]},
            {"ficco_ag_matmul_fused": routes})


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


def _kind(name: str) -> str:
    """A device event's kind, from its name, for the trace's breakdown."""
    low = name.lower()
    for kind, keys in (("memcpy", ("memcpy",)),
                       ("K1/K2 chunked_gemm.cu", ("chunked_gemm",)),
                       ("cuBLAS GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
                       ("softmax", ("softmax",)),
                       ("reductions", ("reduce",)),
                       ("cat, index, gather", ("cat", "index", "gather",
                                               "scatter")),
                       ("elementwise", ("elementwise",))):
        if any(k in low for k in keys):
            return kind
    return "other"


def phase_trace(label, run):
    """``run`` under torch.profiler: device time by kind, the device's idle
    share over the window, how much of the copies' time ran under kernels
    (chunked_gemm.cu's and any) and every device event's time summed by
    :func:`_kind`.  Returns the numbers of kernel and memcpy events and
    the device's busy ms; raises if the profiler saw no device event."""
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
    if not kernels and not copies:
        raise AssertionError(f"[trace] {label}: torch.profiler recorded no "
                             "device events")
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
    kinds = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kinds.get(_kind(ev.name), (0, 0.0))
            kinds[_kind(ev.name)] = (
                n + 1, us + ev.time_range.end - ev.time_range.start)
    print(f"[trace] {label}: device time by kind: "
          + "; ".join(f"{kind} x{n} {us / 1e3:.2f} ms" for kind, (n, us)
                      in sorted(kinds.items(), key=lambda kv: -kv[1][1])))
    return {"kernels": len(kernels), "copies": len(copies),
            "busy_ms": busy_us / 1e3}


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


def phase_train(device, cfg, params):
    """Full-width training steps on the 2D schedule and dense, from the
    prefill's weights; returns each kernel's launches in the last timed 2D
    training step, as the launch counters read them."""
    import torch

    from repro_torch.configs.base import OverlapConfig, ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import TPGroup, tp_group
    from repro_torch.train.loop import loss_and_grads, make_train_step
    from repro_torch.train.optimizer import (
        OptimizerConfig,
        apply_updates,
        init_state,
    )
    from repro_torch.tree import leaves, named_leaves

    def model_for(**overlap):
        return build_model(dataclasses.replace(
            cfg, overlap=OverlapConfig(**overlap)))

    model_2d = model_for(mode="uniform-fused-2d", backend="collective")
    dense = model_for()  # gspmd_serial: the dense projections
    group = TPGroup(GROUP, device)
    ocfg = OptimizerConfig(warmup_steps=2)
    shape = ShapeConfig("smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    data = SyntheticLM(cfg, shape, seed=0)
    batches = [to_device(data.batch_at(i), device)
               for i in range(1 + TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats(device)

    # Gradients at the first step's state and batch, on both paths.
    with tp_group(group):
        _, _, grads_2d = loss_and_grads(model_2d, params, batches[0])
    _, _, grads_dense = loss_and_grads(dense, params, batches[0])
    _sync()
    named_2d = dict(named_leaves(grads_2d))
    worst = 0.0
    for name, g in named_leaves(grads_dense):
        g2 = named_2d[name]
        if g2.shape != g.shape or not (torch.isfinite(g).all()
                                        and torch.isfinite(g2).all()):
            raise AssertionError(f"[train] gradient {name}: shapes "
                                 f"{tuple(g2.shape)} and {tuple(g.shape)} "
                                 "or not finite")
        if not name.endswith(("ffn/w_up", "ffn/w_gate")):
            continue
        for layer in range(cfg.num_layers):
            got, want = g2[layer].float(), g[layer].float()
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            if got.abs().max().item() == 0 or scale == 0:
                raise AssertionError(f"[train] {name} layer {layer}: zero "
                                     "gradient")
            worst = max(worst, err / scale)
            if err > 5e-2 * scale:
                raise AssertionError(
                    f"[train] {name} layer {layer}: 2D-path gradient "
                    f"differs from dense by {err:.3e} (max |grad| "
                    f"{scale:.3e})")
    print(f"[train] gradients at step 1: all {len(named_2d)} leaves finite "
          f"on both paths; w_up and w_gate nonzero in all {cfg.num_layers} "
          f"layers, 2D path vs dense max |diff| / max |grad| per layer "
          f"{worst:.3e} (limit 5e-2)")
    del grads_2d, grads_dense, named_2d

    # The DMA backend's kernels have no reverse-mode rule: refused.
    try:
        with tp_group(group):
            loss_and_grads(model_for(mode="uniform-fused-1d", backend="dma"),
                           params, batches[0])
    except RuntimeError as e:
        if "reverse-mode" not in str(e):
            raise
        print(f"[train] DMA backend under grad raises: {e}")
    else:
        raise AssertionError("[train] the DMA backend did not refuse to be "
                             "differentiated")

    # K2 runs per layer, per up and gate projection, per step of the 2D
    # schedule; with ``remat`` the backward recomputes every period's
    # forward, so twice.
    per_step = cfg.num_layers * 2 * GROUP * (2 if cfg.remat else 1)
    paths = {"2D path": (make_train_step(model_2d, ocfg), group,
                         {"accumulate_matmul": per_step}),
             "dense": (make_train_step(dense, ocfg), None, {})}
    # Both paths start from the prefill's weights and fresh moments.
    states = dict.fromkeys(paths, {"params": params,
                                   "opt_state": init_state(params)})
    walls = {label: [] for label in paths}
    metrics = {label: [] for label in paths}
    train_counts = {}
    for i, batch in enumerate(batches):
        for label, (step, grp, expected) in paths.items():
            _sync()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with tp_group(grp):
                states[label], m = step(states[label], batch)
            _sync()
            walls[label].append((time.perf_counter() - t0) * 1e3)
            counts, routes = ops.launch_counts(), ops.route_counts()
            want = {name: expected.get(name, 0) for name in counts}
            want_routes = {
                name: {r: expected.get(name, 0) if r == PATH_ROUTES[name]
                       else 0 for r in per_route}
                for name, per_route in routes.items()
            }
            if counts != want or routes != want_routes:
                raise AssertionError(
                    f"[train] {label} step {i + 1}: launches {counts} by "
                    f"route {routes}, expected {want} by route "
                    f"{want_routes}")
            if label == "2D path":
                train_counts = counts
            metrics[label].append({k: float(v) for k, v in m.items()})
            if not all(map(math.isfinite, metrics[label][-1].values())):
                raise AssertionError(f"[train] {label} step {i + 1}: "
                                     f"metrics {metrics[label][-1]}")
        if i == 0:
            moved = 0
            for (name, p0), (_, p1) in zip(
                    named_leaves(params),
                    named_leaves(states["2D path"]["params"])):
                changed = int((p0 != p1).sum())
                # A bf16 norm scale of 1.0 moves once an update passes
                # half its ulp (2^-8), later in the warm-up.
                if not name.endswith("scale") and not changed:
                    raise AssertionError(f"[train] {name} did not change in "
                                         "a step")
                moved += changed
            print(f"[train] step 1 moved {moved} of "
                  f"{sum(p.numel() for p in leaves(params))} parameters "
                  "(every leaf but the norm scales moved)")
    first_2d, first_dense = metrics["2D path"][0], metrics["dense"][0]
    for key, limit in (("loss", 1e-2), ("grad_norm", 5e-2)):
        diff = abs(first_2d[key] - first_dense[key])
        print(f"[train] step 1 {key}: 2D path {first_2d[key]:.6f}, dense "
              f"{first_dense[key]:.6f} (relative diff "
              f"{diff / abs(first_dense[key]):.3e}, limit {limit})")
        if diff > limit * abs(first_dense[key]):
            raise AssertionError(f"[train] step 1 {key} of the 2D path "
                                 "differs from dense")
    tokens_n = TRAIN_BATCH * TRAIN_SEQ
    for label in paths:
        timed = walls[label][1:]
        med = statistics.median(timed)
        print(f"[train] {cfg.name} full width, {TRAIN_BATCH}x{TRAIN_SEQ} "
              f"tokens, {label}: step wall median {med:.2f} ms over "
              f"{len(timed)} steps (min {min(timed):.2f}, max "
              f"{max(timed):.2f}; warm-up {walls[label][0]:.2f}), "
              f"{tokens_n / med * 1e3:.0f} tok/s; loss "
              + " -> ".join(f"{m['loss']:.4f}" for m in metrics[label])
              + "; lr " + ", ".join(f"{m['lr']:.2e}" for m in metrics[label]))
    remat = (f" x 2 (the forward, and its recomputation in the backward: "
             f"remat, policy {cfg.remat_policy!r})" if cfg.remat else "")
    print(f"[train] launches in the last timed 2D training step: "
          f"{train_counts} (K2: {cfg.num_layers} layers x 2 projections x "
          f"{GROUP} steps{remat}, all on wgmma); peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
          f"on {_card()}")

    def one_2d_step():
        with tp_group(group):
            paths["2D path"][0](states["2D path"], batches[0])

    busy = phase_trace("2D-path train step", one_2d_step)["busy_ms"]

    # Where a 2D step's wall goes, unprofiled, on the profiled step's state
    # and batch: the whole step, then its forward and backward and its
    # AdamW update with a synchronise between them (medians of 3).
    state_2d = states["2D path"]
    split = {"whole step": [], "forward + backward": [], "AdamW update": []}
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        one_2d_step()
        _sync()
        t1 = time.perf_counter()
        with tp_group(group):
            _, _, grads = loss_and_grads(model_2d, state_2d["params"],
                                         batches[0])
        _sync()
        t2 = time.perf_counter()
        apply_updates(state_2d["params"], grads, state_2d["opt_state"], ocfg)
        _sync()
        split["whole step"].append((t1 - t0) * 1e3)
        split["forward + backward"].append((t2 - t1) * 1e3)
        split["AdamW update"].append((time.perf_counter() - t2) * 1e3)
        del grads
    print("[train] one 2D step, split (wall, median of 3): "
          + ", ".join(f"{k} {statistics.median(v):.2f} ms (min {min(v):.2f},"
                      f" max {max(v):.2f})" for k, v in split.items()))
    whole = statistics.median(split["whole step"])
    # The profiler's host cost stretches its window; the busy time over
    # the unprofiled wall of the same step is the idle share without it.
    print(f"[train] 2D step: device busy {busy:.2f} ms (profiled) over the "
          f"unprofiled whole-step wall {whole:.2f} ms: idle share "
          f"{1 - busy / whole:.3f}")

    # What recomputation saves: the 2D path's forward + backward, with the
    # config's remat and without it, each from the same state and batch;
    # the device memory it takes above what was allocated at its start,
    # and its wall.  (The phase's peak above is the optimizer's: it holds
    # a path's old and new state while the other path's is alive.)
    for remat in (cfg.remat, not cfg.remat):
        model = build_model(dataclasses.replace(model_2d.config, remat=remat))
        _sync()
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        with tp_group(group):
            _, _, grads = loss_and_grads(model, state_2d["params"],
                                         batches[0])
        _sync()
        wall = (time.perf_counter() - t0) * 1e3
        del grads
        peak = torch.cuda.max_memory_allocated(device)
        print(f"[train] 2D path forward + backward, remat {remat} "
              f"(policy {cfg.remat_policy!r}): peak {peak / 2**30:.2f} GiB, "
              f"{(peak - start) / 2**30:.2f} GiB above its start "
              f"({start / 2**30:.2f} GiB), wall {wall:.2f} ms")
    print(f"[train] card: {_card()}")
    return train_counts


# [grid], [fit], [gate]: the design-space grid engine on the card, the
# machine fit and the learned gate.  Sizes: a dense grid of GRID_DENSE
# synthetic scenarios and a ragged one of GRID_RAGGED, each over the whole
# machine grid; the fit's measured records at FIT_SIZES rows of the
# projection; the gate trained at the reference's test sizes.
GRID_DENSE, GRID_RAGGED = 100_000, 20_000
GRID_RTOL = 1e-9
FIT_SIZES = (512, 2048, 8192, 32768)
PICKS = 20


def _timed(fn):
    """(result, host seconds) of ``fn`` run to completion on the card."""
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def _grid_check(label, got, want):
    """Valid totals within GRID_RTOL of the numpy engine's, and the same
    best schedule wherever the top two valid totals are not tied within
    GRID_RTOL.  Returns (max relative difference, untied points)."""
    import numpy as np

    if not np.array_equal(got.valid, want.valid):
        raise AssertionError(f"[grid] {label}: validity masks differ")
    ok = want.valid
    rel = np.abs(got.total[ok] - want.total[ok]) / np.abs(want.total[ok])
    worst = float(rel.max())
    t = np.sort(np.where(ok, want.total, np.inf), axis=0)
    untied = (t[1] - t[0]) > GRID_RTOL * t[0]
    same = got.best_idx() == want.best_idx()
    if worst > GRID_RTOL or not same[untied].all():
        raise AssertionError(
            f"[grid] {label}: max relative difference {worst:.3e}, "
            f"{int((~same[untied]).sum())} untied best_idx differ")
    return worst, int(untied.sum())


def phase_grid(device):
    """The ``"torch"`` grid engine on the card against the ``"numpy"``
    engine on the host: a dense and a ragged grid over the machine grid,
    points per second on each (the card synchronised, a warm-up first);
    ``calibrate_tau`` on the card against its scan-and-bisect reference;
    and the analytic tier's pick latency at the projection on each
    backend."""
    from repro_torch.autotune import AutotuneCache, Autotuner, torchgrid
    from repro_torch.core import H100_SXM, TABLE_I, GemmShape
    from repro_torch.core.engine import GRID_SCHEDULES, TorchEngine, get_engine
    from repro_torch.core.workload import machine_grid
    from repro_torch.sweep import synthetic_batch, synthetic_ragged_batch

    card = _card()
    machines = machine_grid()
    on_card, on_host = TorchEngine(device), get_engine("numpy")
    for warm in (synthetic_batch(1000, seed=5),
                 synthetic_ragged_batch(1000, seed=6)):
        on_card.evaluate(warm, machines)
    raw_fn = {"dense": torchgrid.evaluate_grid_raw,
              "ragged": torchgrid.evaluate_ragged_grid_raw}
    rates = {}
    for label, batch in (
            ("dense", synthetic_batch(GRID_DENSE, seed=0)),
            ("ragged", synthetic_ragged_batch(GRID_RAGGED, seed=1))):
        _, t_raw = _timed(lambda: raw_fn[label](batch, machines,
                                                device=device))
        got, t_card = _timed(lambda: on_card.evaluate(batch, machines))
        want, t_host = _timed(lambda: on_host.evaluate(batch, machines))
        worst, untied = _grid_check(label, got, want)
        points = len(batch) * len(machines)
        rates[label] = (points / t_card, points / t_host)
        print(f"[grid] {label}: {len(batch)} scenarios x {len(machines)} "
              f"machines x {len(GRID_SCHEDULES)} schedules; torch on the "
              f"card {t_card * 1e3:.1f} ms ({points / t_card:.4g} points/s; "
              f"{t_raw * 1e3:.1f} ms, {points / t_raw:.4g} points/s with "
              f"the outputs left on the card), numpy on the host "
              f"{t_host * 1e3:.1f} ms ({points / t_host:.4g} points/s): "
              f"{t_host / t_card:.2f}x; max relative difference of valid "
              f"totals {worst:.3e} (limit {GRID_RTOL:g}); best_idx equal "
              f"at all {untied} untied points [{card}]")

    gemms = [sc.gemm for sc in TABLE_I]
    tau, t_tau = _timed(lambda: torchgrid.calibrate_tau(
        H100_SXM, gemms, device=device))
    tau_ref, t_ref = _timed(lambda: torchgrid.calibrate_tau_reference(
        H100_SXM, gemms, device=device))
    print(f"[grid] calibrate_tau({H100_SXM.name}, Table I) on the card: "
          f"{tau:.6g} ({t_tau:.2f} s, Adam by autograd) vs the scan-and-"
          f"bisect reference {tau_ref:.6g} ({t_ref:.2f} s): "
          f"{abs(tau / tau_ref - 1) * 100:.3f}% apart (limit 5%) [{card}]")
    if not abs(tau / tau_ref - 1.0) < 0.05:
        raise AssertionError(f"[grid] calibrate_tau {tau} vs {tau_ref}")

    gemm = GemmShape(PREFILL_BATCH * PREFILL_SEQ, D_FF, D_MODEL, 2)
    picks = {}
    for backend in ("numpy", "torch"):
        tuner = Autotuner(AutotuneCache(path=os.path.join(
            os.environ["REPRO_AUTOTUNE_CACHE_DIR"], f"pick-{backend}.json")),
            backend=backend, persist=False, audit=False)
        times = []
        for _ in range(PICKS + 1):
            tuner.cache.entries.clear()
            dec, dt = _timed(lambda: tuner.pick(gemm, H100_SXM, group=GROUP))
            if dec.source != "analytic":
                raise AssertionError(f"[grid] {backend} pick: {dec}")
            times.append(dt * 1e3)
        picks[backend] = (dec, statistics.median(times[1:]))
    (d_np, ms_np), (d_t, ms_t) = picks["numpy"], picks["torch"]
    print(f"[grid] analytic pick at {d_np.key} (median of {PICKS} misses "
          f"after a warm-up): numpy {ms_np:.3f} ms -> {d_np.schedule.value}, "
          f"torch {ms_t:.3f} ms -> {d_t.schedule.value} [{card}]")
    if d_np.schedule is not d_t.schedule or not math.isclose(
            d_np.model_total_s, d_t.model_total_s, rel_tol=GRID_RTOL):
        raise AssertionError(f"[grid] picks differ: {d_np} vs {d_t}")
    return {"rates": rates, "tau": (tau, tau_ref),
            "pick_ms": {"numpy": ms_np, "torch": ms_t}}


def phase_fit(device, tuner):
    """``fit_machine`` on the card: first the reference's recovery test on
    a perturbed ``H100_SXM``, then ``H100_SXM``'s link constants fitted to
    the times ``Autotuner.measure`` records at FIT_SIZES rows of the
    projection.  The fit is printed, persisted and read back, and not
    deployed: on one card the logical group's exchange is device-memory
    copies, not NVLink.  Returns the measured records."""
    import numpy as np
    import torch

    from repro_torch.autotune import torchgrid
    from repro_torch.core import H100_SXM, GemmShape, machine_for_group
    from repro_torch.core.engine import GRID_SCHEDULES
    from repro_torch.core.schedule_types import Schedule
    from repro_torch.core.workload import synthetic_scenarios
    from repro_torch.learn import (
        fit_machine,
        load_fit,
        records_from_cache,
        save_fit,
        synthesize_records,
    )
    from repro_torch.parallel.sharding import shard_columns

    card = _card()
    params = ("link_bw", "s_half")
    true = {"link_bw": H100_SXM.link_bw * 0.8, "s_half": 3.2e6}
    records = synthesize_records(
        H100_SXM, [sc.gemm for sc in synthetic_scenarios(12)],
        (Schedule.SERIAL, Schedule.UNIFORM_FUSED_1D,
         Schedule.HETERO_UNFUSED_1D),
        overrides=true, device=device)
    fit, secs = _timed(lambda: fit_machine(H100_SXM, records, params=params,
                                           steps=300, device=device))
    errs = {p: fit.fitted[p] / true[p] - 1.0 for p in params}
    print(f"[fit] recovery: {len(records)} records synthesized from "
          f"{H100_SXM.name} with link_bw x 0.8 and s_half 3.2e6; "
          f"fit_machine on the card in {secs:.2f} s (300 Adam steps): "
          + ", ".join(f"{p} {fit.initial[p]:.6g} -> {fit.fitted[p]:.6g} "
                      f"(true {true[p]:.6g}, {errs[p] * 100:+.4f}%)"
                      for p in params)
          + f"; loss {fit.loss0:.4e} -> {fit.loss:.4e} [{card}]")
    if not (fit.loss < fit.loss0 and all(abs(e) < 0.05
                                         for e in errs.values())):
        raise AssertionError(f"[fit] recovery: {fit}")

    randn = _randn_fn(device, 8)
    w = shard_columns(randn(D_MODEL, D_FF, dtype=torch.bfloat16,
                            scale=D_MODEL ** -0.5), GROUP)
    for m in FIT_SIZES:
        x = randn(GROUP, m // GROUP, D_MODEL, dtype=torch.bfloat16)
        dec = tuner.measure(x, w, schedules=list(Schedule), iters=3)
        print(f"[fit] measure at {dec.key}: "
              + ", ".join(f"{s} {t * 1e3:.4f}" for s, t in dec.shortlist)
              + f" ms -> {dec.schedule.value} [{card}]")
    records = sorted(records_from_cache(tuner.cache, H100_SXM.name),
                     key=lambda r: r.gemm.m)
    if len(records) != len(FIT_SIZES):
        raise AssertionError(f"[fit] {len(records)} measured records")
    fit, secs = _timed(lambda: fit_machine(H100_SXM, records, params=params,
                                           device=device))
    if not (all(math.isfinite(fit.fitted[p]) and fit.fitted[p] > 0
                for p in params) and math.isfinite(fit.loss)
            and fit.loss <= fit.loss0):
        raise AssertionError(f"[fit] measured fit: {fit}")
    save_fit(fit, cache=tuner.cache)
    if load_fit(f"{fit.machine}/g{fit.group}", cache=tuner.cache) != fit:
        raise AssertionError("[fit] the FitResult did not survive "
                             "save_fit/load_fit")
    eff = machine_for_group(H100_SXM, GROUP)
    gemms = [r.gemm for r in records]
    rows = [GRID_SCHEDULES.index(r.schedule) for r in records]
    before, after = (
        torchgrid.evaluate_grid_raw(gemms, mp)[0][0].cpu().numpy()
        for mp in (torchgrid.machine_arrays((eff,), device=device),
                   fit.machine_arrays(device=device)))
    lanes = np.arange(len(records))
    print(f"[fit] {H100_SXM.name} at group {GROUP} fitted to {len(records)} "
          f"records measured on this card ({secs:.2f} s): "
          + ", ".join(f"{p} {fit.initial[p]:.6g} -> {fit.fitted[p]:.6g} "
                      f"(x {fit.scale(p):.4g})" for p in params)
          + f"; loss {fit.loss0:.4e} -> {fit.loss:.4e}; survives "
          f"save_fit/load_fit [{card}]")
    print("[fit] per record, measured vs model ms before -> after the fit: "
          + ", ".join(f"m{r.gemm.m} {r.schedule.value} {r.seconds * 1e3:.4f}"
                      f" vs {b * 1e3:.4f} -> {a * 1e3:.4f}"
                      for r, b, a in zip(records, before[rows, lanes],
                                         after[rows, lanes]))
          + " (not deployed: on one card the group's exchange is "
          f"device-memory copies, not NVLink) [{card}]")
    return records, fit


def phase_gate(device, tuner, records):
    """``sweep_stats`` in reduce mode on the ``"torch"`` engine on the card,
    ``train_gate_from_stats``, and ``gate_accuracy`` on the held-out grids
    of the reference's headline test at its thresholds (on its machine
    grid: MI300X and TPU v5e); the gate installed with
    ``Autotuner.set_gate`` and read back from a pick's decision record;
    the ``"measured"`` engine's shortlist ranking from [fit]'s records."""
    from repro_torch.autotune import AutotuneCache, Autotuner
    from repro_torch.core import (
        H100_SXM,
        TABLE_I,
        GemmShape,
        machine_for_group,
        synthetic_scenarios,
    )
    from repro_torch.core.batch import RaggedBatch, ScenarioBatch
    from repro_torch.core.engine import get_engine, shortlist
    from repro_torch.core.workload import (
        machine_grid,
        ragged_scenario_grid,
        scenario_grid,
    )
    from repro_torch.learn import (
        MeasuredEngine,
        gate_accuracy,
        sweep_stats,
        train_gate_from_stats,
    )
    from repro_torch.sweep import synthetic_batch, synthetic_ragged_batch

    card = _card()
    on_card = get_engine("torch")
    fam = ragged_scenario_grid(
        steps=8, skews=(1.0, 2.0, 4.0), zipf_alphas=(1.0,),
        top_k=((2, 0.6),),
        scenarios=[s for s in TABLE_I if s.parallelism == "EP"]
        + synthetic_scenarios(12))
    held_out = {
        "skewed EP family": RaggedBatch.from_ragged_scenarios(fam),
        "held-out Dirichlet": synthetic_ragged_batch(1500, seed=99),
        "uniform scenario_grid": ScenarioBatch.from_scenarios(
            scenario_grid()),
    }

    def train(machines):
        t0 = time.perf_counter()
        stats_r, _ = sweep_stats(synthetic_ragged_batch(2000, seed=7),
                                 machines, backend="torch", num_shards=8)
        stats_u, _ = sweep_stats(synthetic_batch(2000, seed=8), machines,
                                 backend="torch", num_shards=8)
        gate = train_gate_from_stats(stats_r + stats_u)
        acc = {}
        for name, batch in held_out.items():
            grid = on_card.evaluate(batch, machines)
            acc[name] = (gate_accuracy(grid), gate_accuracy(grid, gate))
        return gate, stats_r.n_points + stats_u.n_points, acc, (
            time.perf_counter() - t0)

    def show(label, gate, n, acc, secs):
        print(f"[gate] {label}: trained from {n} points in reduce mode on "
              f"the card ({gate.n_leaves} leaves), within-5% accuracy "
              "scalar -> learned: "
              + ", ".join(f"{k} {a:.4f} -> {b:.4f}"
                          for k, (a, b) in acc.items())
              + f" ({secs:.2f} s) [{card}]")

    gate, n, acc, secs = train(machine_grid()[:8])
    show("the reference's machine grid (MI300X, TPU v5e)", gate, n, acc,
         secs)
    (s_fam, l_fam), (s_ho, l_ho), (s_u, l_u) = acc.values()
    if not (l_fam >= 0.75 and l_fam >= s_fam and l_ho >= 0.75
            and l_ho > s_ho and l_u >= s_u - 0.005):
        raise AssertionError(f"[gate] accuracies {acc}")
    show("the whole machine grid (H100_SXM's variants too; not asserted)",
         *train(machine_grid()))

    gemm = GemmShape(PREFILL_BATCH * PREFILL_SEQ, D_FF, D_MODEL, 2)
    picker = Autotuner(AutotuneCache(path=os.path.join(
        os.environ["REPRO_AUTOTUNE_CACHE_DIR"], "gate-pick.json")),
        persist=False, audit=False)
    picker.set_gate(gate)
    dec = picker.pick(gemm, H100_SXM, group=GROUP)
    print(f"[gate] set_gate, then pick at {dec.key}: {dec.schedule.value} "
          f"({dec.source}); gate verdict {dec.gate} [{card}]")
    if (dec.source not in ("analytic", "heuristic") or not dec.gate
            or dec.gate.get("kind") != "LearnedGate"):
        raise AssertionError(f"[gate] the decision record carries no "
                             f"learned gate: {dec}")

    measured = MeasuredEngine(tuner.cache, top=6)
    eff = machine_for_group(H100_SXM, GROUP)
    for rec in records:
        ranked = shortlist(rec.gemm, eff, top=6, engine=measured)
        print(f"[gate] measured-engine shortlist at m{rec.gemm.m}: "
              + ", ".join(f"{s.value} {t * 1e3:.4f}" for s, t in ranked)
              + f" ms [{card}]")
        if (rec.schedule, rec.seconds) not in ranked:
            raise AssertionError(f"[gate] {rec} not in the measured "
                                 f"shortlist {ranked}")


def phase_learn(device):
    """[fit] and [gate] in a cache directory of their own: the measured
    records [fit] writes are what [gate]'s measured engine ranks from."""
    from repro_torch.autotune import AutotuneCache, Autotuner

    with tempfile.TemporaryDirectory(prefix="learn-") as cache_dir:
        tuner = Autotuner(AutotuneCache(path=os.path.join(
            cache_dir, "learn.json")), audit=False)
        records, fit = phase_fit(device, tuner)
        phase_gate(device, tuner, records)
    return fit


# [moe]: DeepSeek-V2-Lite-16B whole, and the expert-parallel dispatch at
# its MoE layer: GROUP ranks of PREFILL_SEQ tokens each route top-6 of 64
# experts at capacity factor 1.25, so 512 * 6 * 1.25 / 64 = 60 rows per
# expert and rank.
MOE_ARCH = "deepseek-v2-lite-16b"
EP_CAPACITY = 60
EP_SIZES = (20, 0, 25, 15)  # explicit chunk sizes with an empty chunk


def _moe_work(cfg, batch: int, seq: int, ctx: float) -> dict:
    """Operations of one forward over (batch, seq) new tokens that attend
    to ``ctx`` positions each on average, by part, as the reference's
    arithmetic runs them: the routed experts at capacity, every
    projection, the router, the causal attention and the unembedding."""
    d, h, n = cfg.d_model, cfg.num_heads, cfg.num_layers
    m, e = cfg.mla, cfg.moe
    t = batch * seq
    qk = m.nope_head_dim + m.rope_head_dim
    cap = int(max(e.capacity_factor * t * e.top_k / e.num_experts, 4))
    per_token_mla = (d * h * qk + d * (m.kv_lora_rank + m.rope_head_dim)
                     + m.kv_lora_rank * h * (m.nope_head_dim + m.v_head_dim)
                     + h * m.v_head_dim * d)
    return {
        "routed experts": n * 3 * 2 * e.num_experts * cap * d * e.d_ff_expert,
        "shared experts": n * 3 * 2 * t * d * e.d_ff_expert
        * e.num_shared_experts,
        "MLA projections": n * 2 * t * per_token_mla,
        "router": n * 2 * t * d * e.num_experts,
        "attention": n * 2 * t * ctx * h * (qk + m.v_head_dim),
        "unembedding": 2 * t * d * cfg.vocab_size,
    }


class _Routing:
    """Within ``with``: wraps ``repro_torch.models.moe.route`` so each call
    records its top-k experts (``calls``) or, while ``replay`` holds an
    iterator, takes its experts from it, their weights renormalised from
    the call's own probabilities.  Replaying one run's choices in another
    holds the two to the same discrete routing, so what remains between
    them is arithmetic."""

    def __init__(self):
        self.calls, self.replay = [], None

    def __enter__(self):
        from repro_torch.models import moe

        self.module, self.orig = moe, moe.route
        moe.route = self
        return self

    def __exit__(self, *exc):
        self.module.route = self.orig

    def __call__(self, params, xf, mcfg):
        logits, probs, top_w, top_e = self.orig(params, xf, mcfg)
        if self.replay is not None:
            top_e = next(self.replay)
            top_w = probs.gather(-1, top_e)
            top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        self.calls.append(top_e)
        return logits, probs, top_w, top_e

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def _choices_differ(a, b, num_experts: int) -> float:
    """Share of (token, k) expert choices in ``a`` that ``b`` lacks."""
    import torch

    def hot(idx):
        return torch.zeros(idx.shape[0], num_experts, device=idx.device
                           ).scatter_(1, idx, 1.0)

    return ((hot(a) - hot(b)).clamp_min(0).sum() / a.numel()).item()


def _dropped_share(choices, cfg, tokens: int) -> float:
    """Share of the (token, k) assignments that the capacity clip drops."""
    import torch

    e = cfg.moe.num_experts
    cap = int(max(cfg.moe.capacity_factor * tokens * cfg.moe.top_k / e, 4))
    drops = total = 0
    for idx in choices:
        counts = torch.zeros(e, device=idx.device).index_add_(
            0, idx.reshape(-1), torch.ones(idx.numel(), device=idx.device))
        drops += (counts - cap).clamp_min(0).sum().item()
        total += idx.numel()
    return drops / total


def phase_moe(device, timer):
    """DeepSeek-V2-Lite-16B at full width: build, dense and DMA-path
    prefill, the logits and the MLA cache checked, ``DecodeEngine``, then
    the expert-parallel dispatch at the model's MoE layer.  Returns each
    kernel's launches in one DMA-path prefill."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OverlapConfig
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import TPGroup, tp_group
    from repro_torch.serve.engine import make_prefill
    from repro_torch.tree import named_leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(
        get_config(MOE_ARCH),
        overlap=OverlapConfig(mode="ficco_auto", backend="dma"))
    m, e = cfg.mla, cfg.moe
    print(f"[moe] {cfg.name}: {cfg.num_layers} layers "
          f"({[s.ffn for s in build_model(cfg).pattern]} per period), d "
          f"{cfg.d_model}, {cfg.num_heads} heads, MLA kv_lora "
          f"{m.kv_lora_rank} / rope {m.rope_head_dim} / nope "
          f"{m.nope_head_dim} / v {m.v_head_dim}; {e.num_experts} experts "
          f"top-{e.top_k} + {e.num_shared_experts} shared, d_ff_expert "
          f"{e.d_ff_expert}, capacity factor {e.capacity_factor}; vocab "
          f"{cfg.vocab_size}; {cfg.dtype}")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    state = model.init(0, device=device)
    _sync()
    init_s = time.time() - t0
    leaves = named_leaves(state)
    n_params = sum(t.numel() for _, t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    fp32 = sorted({p.split("/")[-1] for p, t in leaves
                   if t.dtype == torch.float32})
    gib = 2 ** 30
    print(f"[moe] {n_params / 1e9:.3f}e9 parameters, {n_bytes / 1e9:.2f} GB "
          f"(fp32 leaves: {fp32}); random weights (seed 0) in {init_s:.1f}s;"
          f" allocated after init "
          f"{torch.cuda.memory_allocated(device) / gib:.2f} GiB, init peak "
          f"{torch.cuda.max_memory_allocated(device) / gib:.2f} GiB")
    embed_bytes = state["embed"].numel() * state["embed"].element_size()

    # (b) prefill, dense and on the DMA path, with the routing recorded.
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ),
                           generator=gen, device=device)
    batch = {"tokens": tokens}
    prefill = make_prefill(model)
    group = TPGroup(GROUP, device)
    n_tok = PREFILL_BATCH * PREFILL_SEQ
    torch.cuda.reset_peak_memory_stats(device)
    want_shape = (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab_size)
    layers_n = cfg.num_layers
    with torch.no_grad(), _Routing() as routing:
        dense = prefill(state, batch)
        dense_choices = routing.take()
        again = prefill(state, batch)
        routing.take()
        ops.reset_launch_counts()
        with tp_group(group):
            dma = prefill(state, batch)
        _sync()
        counts, routes = ops.launch_counts(), ops.route_counts()
        dma_choices = routing.take()
    prefill_peak = torch.cuda.max_memory_allocated(device)
    k3 = cfg.num_layers * 2 * GROUP
    n_local = e.d_ff_expert * e.num_shared_experts // GROUP
    print(f"[moe] DMA-path prefill {PREFILL_BATCH}x{PREFILL_SEQ}: launches "
          f"{counts} (K3 expected {k3}: {cfg.num_layers} layers x 2 shared-"
          f"expert projections x {GROUP} steps; K1 as the composer's blocked"
          f" rule falls: n_local {n_local}); by route {routes}")
    if (counts["a2a_chunk_exchange"] != k3
            or routes["a2a_chunk_exchange"] != {"strided": k3, "pairs": 0}
            or counts["accumulate_matmul"] or counts["ficco_ag_matmul_fused"]):
        raise AssertionError(f"[moe] DMA-path launches {counts} by route "
                             f"{routes}; expected K3 = {k3} on strided and "
                             "no K2 or K4")
    for label, lg in (("dense", dense), ("DMA path", dma)):
        if tuple(lg.shape) != want_shape or not torch.isfinite(lg).all():
            raise AssertionError(f"[moe] {label} logits {tuple(lg.shape)} "
                                 f"not finite or not {want_shape}")

    # (c) the logits: the DMA path against dense.  A near-tied router
    # choice flips where the two round differently, and moves which
    # assignments the capacity drops: the share is printed beside them.
    flipped = [_choices_differ(a, b, e.num_experts)
               for a, b in zip(dense_choices, dma_choices)]
    print(f"[moe] dense prefill run to run: "
          f"{'bit-equal' if torch.equal(again, dense) else 'not bit-equal'}"
          f"; expert choices that differ between the dense and DMA paths: "
          f"{statistics.mean(flipped):.2e} of (token, k) over {layers_n} "
          f"layers (max {max(flipped):.2e} in one); assignments dropped "
          f"past capacity in the dense prefill: "
          f"{_dropped_share(dense_choices, cfg, n_tok):.4f}")
    scale = dense.float().abs().max().item()
    per_token = (dma.float() - dense.float()).abs().amax(-1).flatten()
    err = per_token.max().item()
    agree = (dma.argmax(-1) == dense.argmax(-1)).float().mean().item()
    print(f"[moe] DMA-path logits vs dense: max_abs_err {err:.4e} (max "
          f"|logit| {scale:.4f}, ratio {err / scale:.3e}); per-token max "
          f"|d| median {per_token.median().item():.3e}, tokens above 5%: "
          f"{int((per_token > 5e-2 * scale).sum())} of {n_tok}; argmax "
          f"agreement {agree:.4f}")
    if err > 5e-2 * scale:
        raise AssertionError(f"[moe] DMA-path logits differ from dense by "
                             f"{err} (> 5% of {scale})")
    del dense, again, dma
    gc.collect()

    with torch.no_grad():
        def in_group(run):
            def go():
                with tp_group(group):
                    run(state, batch)
            return go

        timed = [("DMA path", in_group(prefill)),
                 ("dense", lambda: prefill(state, batch))]
        walls = {}
        for name, fn in timed * 2:
            ms = wall_ms(fn, reps=3)
            walls.setdefault(name, []).append(ms)
            print(f"[moe] prefill {PREFILL_BATCH}x{PREFILL_SEQ}, {name}: "
                  f"{ms:.2f} ms wall ({n_tok / ms * 1e3:.0f} tok/s)")
        work = _moe_work(cfg, PREFILL_BATCH, PREFILL_SEQ, PREFILL_SEQ / 2)
        # Every weight read once (the embedding: the rows of these
        # tokens), the tokens read and the logits written.
        moved = (n_bytes - embed_bytes + n_tok * cfg.d_model * 2
                 + tokens.numel() * 8 + math.prod(want_shape) * 2)
        bound, by = _bound(sum(work.values()), moved, torch.bfloat16)
        print(f"[moe] prefill bound {bound:.2f} ms by {by} "
              f"({sum(work.values()) / 1e12:.2f} TFLOP: "
              + ", ".join(f"{k} {v / 1e12:.2f}" for k, v in work.items())
              + f"; {moved / 1e9:.2f} GB); best wall over the bound: DMA "
              f"path {min(walls['DMA path']) / bound:.2f}x, dense "
              f"{min(walls['dense']) / bound:.2f}x")
        stats = phase_trace("DeepSeek DMA-path prefill", in_group(prefill))
        if stats["copies"] < k3 * GROUP:
            raise AssertionError(f"[moe] DMA-path trace: {stats['copies']} "
                                 f"memcpy events, fewer than K3's "
                                 f"{k3 * GROUP} copies")
        phase_trace("DeepSeek dense prefill", lambda: prefill(state, batch))
    print(f"[moe] peak memory of the two checked prefills "
          f"{prefill_peak / 2**30:.2f} GiB")

    # (c) cached decode through the MLA latent cache against the forward.
    phase_moe_decode(device, cfg, state, n_bytes - embed_bytes)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    phase_moe_dispatch(device, timer, cfg)
    return counts


def phase_moe_decode(device, cfg, state, weight_bytes: int):
    """[moe] (c) the MLA cache against the forward, and (d) DecodeEngine.

    A decode step's 4 tokens never overflow an expert's capacity of 4; the
    forward's 32 prompt tokens may, so (c) runs both at capacity factor
    E / k, where nothing is dropped.  A decode step's GEMMs (4 rows) round
    differently from the forward's (32), and near-tied router choices
    flip: (c) prints the free-running decode and holds to 5 % the decode
    that takes the forward's expert choices (:class:`_Routing`)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import OverlapConfig
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import DecodeEngine, Request

    prompts, prompt_len, new_tokens, cache_len = 4, 8, 16, 128
    no_drop = dataclasses.replace(
        cfg, overlap=OverlapConfig(),
        moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = build_model(no_drop)
    raw = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (prompts, prompt_len))
    toks = torch.as_tensor(raw, device=device)

    def decode():
        cache = model.init_cache(prompts, cache_len, device=device)
        steps = []
        for pos in range(prompt_len):
            lg, cache = model.decode_step(state, cache, toks[:, pos:pos + 1],
                                          pos)
            steps.append(lg)
        return torch.cat(steps, dim=1), cache

    with torch.no_grad(), _Routing() as routing:
        full, _ = model.forward(state, {"tokens": toks})
        # The forward's choices for token (b, p) in layer l, in the order
        # the decode steps ask for them: step p, layer l, rows b.
        fwd = [c.view(prompts, prompt_len, -1) for c in routing.take()]
        free, _ = decode()
        calls, n, k = routing.take(), cfg.num_layers, cfg.moe.top_k
        flipped = statistics.mean(
            _choices_differ(f.reshape(-1, k),
                            torch.stack(calls[i::n], 1).reshape(-1, k),
                            cfg.moe.num_experts)
            for i, f in enumerate(fwd))
        routing.replay = iter([f[:, p] for p in range(prompt_len)
                               for f in fwd])
        decoded, cache = decode()
        routing.replay = None
    scale = full.float().abs().max().item()
    cache_mib = _nbytes(*cache[0].values()) / 2 ** 20
    per_token = (free.float() - full.float()).abs().amax(-1).flatten()
    print(f"[moe] decode through the MLA cache ({sorted(cache[0])}, "
          f"{cache_mib:.1f} MiB for {prompts}x{cache_len}) vs forward over "
          f"{prompts}x{prompt_len} prompt tokens, capacity factor "
          f"{no_drop.moe.capacity_factor:.3f} (max |logit| {scale:.4f}): "
          f"free-running max_abs_err {per_token.max().item():.4e}, "
          f"per-token median {per_token.median().item():.3e}, tokens above "
          f"5%: {int((per_token > 5e-2 * scale).sum())} of "
          f"{per_token.numel()}, expert choices that differ {flipped:.2e};"
          f" on the forward's choices max_abs_err "
          f"{_max_err(decoded, full):.4e}")
    err = _max_err(decoded, full)
    if not torch.isfinite(decoded).all() or err > 5e-2 * scale:
        raise AssertionError(f"[moe] decode logits on the forward's routing "
                             f"differ from the forward by {err}")
    del cache, decoded, free, full

    n_steps = []

    def answer():
        eng = DecodeEngine(cfg, state, batch_size=prompts,
                           cache_len=cache_len, device=device)
        step = eng.step_fn

        def counted(*args):
            n_steps.append(1)
            return step(*args)

        eng.step_fn = counted
        reqs = [Request(raw[i].astype(np.int32), max_new_tokens=new_tokens)
                for i in range(prompts)]
        t0 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        return eng, out, time.perf_counter() - t0

    _, _, first = answer()
    n_steps.clear()
    ops.reset_launch_counts()
    eng, out, dt = answer()
    total = sum(len(r.out) for r in out)
    if total != prompts * new_tokens or not all(
        r.done and all(0 <= t < cfg.vocab_size for t in r.out) for r in out
    ):
        raise AssertionError("[moe] DecodeEngine did not answer every "
                             "request")
    per_step = dt * 1e3 / len(n_steps)
    # One step reads every weight once (the embedding: 4 rows) and the
    # latent cache; its operations are those of 4 tokens.
    cache_bytes = (cfg.num_layers * prompts * cache_len
                   * (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * 2)
    moved = weight_bytes + cache_bytes + prompts * cfg.d_model * 2
    work = sum(_moe_work(cfg, prompts, 1,
                         (prompt_len + new_tokens) / 2).values())
    bound, by = _bound(work, moved, torch.bfloat16)
    print(f"[moe] DecodeEngine: {prompts} requests x {new_tokens} new tokens"
          f" (prompt {prompt_len}, cache {cache_len}): {total} tokens in "
          f"{dt:.3f}s, {total / dt:.1f} tok/s (first run {first:.3f}s); "
          f"{len(n_steps)} steps, {per_step:.2f} ms per step against a bound "
          f"of {bound:.2f} ms by {by} ({moved / 1e9:.2f} GB, "
          f"{work / 1e9:.1f} GFLOP), {per_step / bound:.2f}x; launches "
          f"{ops.launch_counts()}")
    print(f"[moe] req0: {[int(t) for t in out[0].prompt]} -> {out[0].out}")
    last = torch.as_tensor([[r.out[-1]] for r in out], device=device)
    with torch.no_grad():
        phase_trace("DeepSeek decode step", lambda: eng.model.decode_step(
            state, eng.cache, last, prompt_len + new_tokens - 1))


def phase_moe_dispatch(device, timer, cfg):
    """[moe] (e): ``serial_a2a_ffn`` and ``ficco_a2a_ffn``'s variants on
    GROUP logical ranks at the model's MoE layer, against each other, each
    timed on the card beside its bound."""
    import torch

    from repro_torch.core.workload import StepProfile
    from repro_torch.overlap import ficco_a2a_ffn, serial_a2a_ffn
    from repro_torch.tune.variants import default_variant

    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    randn = _randn_fn(device, 7)
    x = randn(GROUP, e, EP_CAPACITY, d, dtype=torch.bfloat16)
    w_up = randn(GROUP, e // GROUP, d, f, dtype=torch.bfloat16,
                 scale=d ** -0.5)
    w_down = randn(GROUP, e // GROUP, f, d, dtype=torch.bfloat16,
                   scale=f ** -0.5)
    reverse = dataclasses.replace(
        default_variant("ficco_a2a_ffn", group=GROUP),
        dispatch_order="reverse")
    profile = StepProfile.skewed(GROUP, 2.0)
    runs = {
        "serial": lambda: serial_a2a_ffn(x, w_up, w_down),
        "ficco default": lambda: ficco_a2a_ffn(x, w_up, w_down),
        "ficco chunks=2": lambda: ficco_a2a_ffn(x, w_up, w_down, chunks=2),
        "ficco reverse": lambda: ficco_a2a_ffn(x, w_up, w_down,
                                               variant=reverse),
        "ficco skewed(4, 2.0)": lambda: ficco_a2a_ffn(x, w_up, w_down,
                                                      profile=profile),
        f"ficco sizes {EP_SIZES}": lambda: ficco_a2a_ffn(
            x, w_up, w_down, chunk_sizes=EP_SIZES),
    }
    with torch.no_grad():
        outs = {name: fn() for name, fn in runs.items()}
        _sync()
    serial, default = outs["serial"], outs["ficco default"]
    for name, out in outs.items():
        if not torch.isfinite(out).all():
            raise AssertionError(f"[moe] EP {name}: not finite")
        torch.testing.assert_close(out, serial, rtol=TOL["bfloat16"],
                                   atol=TOL["bfloat16"])
    if not torch.equal(outs["ficco reverse"], default):
        raise AssertionError("[moe] EP: the reverse variant is not bit-equal"
                             " to the default")
    rows = GROUP * EP_CAPACITY
    flops = 2 * 2 * GROUP * (e // GROUP) * rows * d * f
    moved = _nbytes(x, w_up, w_down, serial)
    bound, by = _bound(flops, moved, torch.bfloat16)
    print(f"[moe] EP dispatch: x {tuple(x.shape)} per rank group, w_up "
          f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)} bf16; {rows} "
          f"rows per local expert; bound {bound:.3f} ms by {by} "
          f"({flops / 1e9:.1f} GFLOP, {moved / 1e9:.3f} GB)")
    times = {}
    with torch.no_grad():
        for name, fn in runs.items():
            times[name] = timer(fn)
            same = torch.equal(outs[name], default)
            print(f"[moe] EP {name}: {times[name]:.3f} ms device "
                  f"({times[name] / bound:.2f}x the bound); vs serial "
                  f"max_abs_err {_max_err(outs[name], serial):.3e}, vs the "
                  f"default {_max_err(outs[name], default):.3e}"
                  f"{' (bit-equal)' if same else ''}")
    print(f"[moe] EP ficco default / serial: "
          f"{times['ficco default'] / times['serial']:.3f} (on one card the "
          f"all-to-all is a device copy: the ratio prices cutting the expert"
          f" GEMMs, not overlap)")


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
    with tempfile.TemporaryDirectory(prefix="autotune-") as cache_dir:
        # The kernels resolve an unnamed variant through the tuner's
        # cache: this run reads and writes a directory of its own.
        os.environ["REPRO_AUTOTUNE_CACHE_DIR"] = cache_dir
        return drive(device)


def drive(device) -> int:
    """Every phase in turn; the kernels' line and the result line."""
    import torch

    t_start = time.time()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    phase_build()
    timer = Timer(device)
    k1, k3 = phase_kernels(device, timer)
    kernels = [k1, phase_accumulate(device, timer), k3,
               phase_fused(device, timer)]
    measured, auto = phase_schedules(device, timer)
    design = phase_design(measured, auto)
    cfg, model, state, launches, by_route = phase_prefill(device)
    fused_launches, fused_routes = phase_fused_path(device, cfg, state)
    launches.update(fused_launches)
    by_route.update(fused_routes)
    phase_autotune(device, timer, cfg, state, measured, design)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["routes"] = by_route[k["name"]]
    phase_serve(device, cfg, model, state)
    train_counts = phase_train(device, cfg, state)
    for k in kernels:
        k["train_step_launches"] = train_counts[k["name"]]
    phase_grid(device)
    phase_learn(device)
    # [moe] needs the card's memory: TinyLlama's state goes first.
    del model, state
    moe_counts = phase_moe(device, timer)
    for k in kernels:
        k["moe_prefill_launches"] = moe_counts[k["name"]]

    print(f"[done] every phase passed ({', '.join(PHASES)}) in "
          f"{time.time() - t_start:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches", "routes",
            "train_step_launches", "moe_prefill_launches", "max_abs_err",
            "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
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
