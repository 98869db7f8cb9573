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
     then the serving tier (``[adapt]``, in a cache directory of its
     own): ``AdaptiveTier`` on ``H100_SXM`` at group 4 with its re-fit
     thread running, driven by 4-request batches whose prompt lengths
     drift, at TinyLlama's FFN widths, its measured sessions timed on
     the card by ``Autotuner.measure`` (CUDA events): every pick served,
     none by the heuristic, at least 6 measured sessions with a finite
     time per candidate, K2's launches as the sessions that timed
     uniform-fused-2d imply, every audit record and sentinel event
     valid, and an alarm's re-fit deploying ``link_bw``; picks and their
     latency by tier, the sentinel's state, the re-fit and the recovery;
     ``DecodeEngine(adapt=tier)`` against the same engine without it
     (tokens equal, ms per step, the ``serve/run`` span's schedule); and
     the decode with ``decode_attn="shard_map"`` on the group of 4 at a
     cache of 2048 against the plain decode (5 %), ms per step beside a
     byte bound;
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
     records; then the card-resident design-space sweep (``[sweep]``,
     1e8 scenarios) and the dry-run (``[dryrun]``, no kernel): every
     arch x shape through ``repro_torch.launch.dryrun`` on the 16x16 and
     2x16x16 meshes (host seconds, each pair's bytes per device and
     three roofline terms), one device's shard of the largest training
     state (params, moments, step and batch) allocated on the card at its
     shard shapes with the allocator's growth held to the dry-run's
     argument bytes (512 B a leaf), and the dry-run and hillclimb command
     lines;
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
 12. MoE training (``[moe-train]``): DeepSeek-V2-Lite-16B at full width,
     cut to 2 of its 27 layers, through ``phase_model_train`` as item 14
     sets out (K2 on the shared experts' up/gate projections, 32 launches
     per step with remat);
 13. the encoder-decoder and VLM paths (``[encdec]``, ``[vlm]``) and the
     hybrid and SSM families (``[hybrid]``, ``[ssm]``), each through
     ``phase_model``: SeamlessM4T-v2-large whole, InternVL2-76B at full
     width cut to 8 of its 80 layers, Jamba-1.5-Large at full width cut
     to 4 of its 72 layers (one period of (Mamba, MLP), (Mamba, MoE),
     (attention, MLP), (Mamba, MoE)) and xLSTM-1.3B whole, their
     parameters beside ``repro_torch.roofline``'s count; a 4 x 512
     prefill (Seamless: 512 encoder frames; InternVL2: 256 projected
     patches + 256 text tokens) dense and on the DMA path (K3 + K1 in
     every MLP, the encoder's too) against dense (5 %), or, for xLSTM,
     which has no FiCCO site, a short prompt under the DMA context that
     launches no kernel and equals dense bit for bit; walls and the
     profiled busy time and idle share beside the counters' prefill
     bound; the cached decode (Seamless: cross K/V from
     ``prefill_cross``) against the forward (5 %; xLSTM's in fp32 at full
     depth and in bf16 on one mLSTM and one sLSTM layer), and one
     ``DecodeEngine`` answering the same requests twice with the same
     tokens (each run starts from the initial recurrent state), per step
     beside its byte bound;
 14. training the hybrid and SSM families (``[hybrid-train]``,
     ``[ssm-train]``), each through ``phase_model_train``:
     Jamba-1.5-Large at full width cut to 2 layers, (Mamba, MLP) and
     (attention, MLP) (one MoE layer is 9.66e9 parameters: no cut that
     holds one trains on one card), 4 x 512 ``SyntheticLM`` tokens on the
     uniform-fused-2D schedule (K2 in the MLPs: 16 launches a gradient
     computation, 32 a step with remat) and dense; xLSTM-1.3B cut to its
     first 8 layers (7 mLSTM, 1 sLSTM), 2 x 64 tokens, dense; AdamW, one
     path's state on the card at a time: two equal gradient computations
     bit for bit, every layer's gradient finite and nonzero and each in
     its parameter's dtype, the 2D path's FiCCO-site leaves against
     dense's per period, the DMA backend refused under grad, the 2D
     step's loss (1 %) and gradient norm (5 %) against dense, the
     collectives counted per step; walls beside ``roofline.analyze``'s
     three terms, peak memory beside the prediction, one profiled step;
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
          "autotune", "serve", "adapt", "train", "grid", "fit", "gate",
          "sweep", "dryrun", "moe", "moe-train", "encdec", "vlm", "hybrid",
          "ssm", "hybrid-train", "ssm-train")


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


def _dma_launches(variant, n_sites, n_local=D_FF // GROUP):
    """K1 and K3 launches of ``n_sites`` DMA-path projections of
    ``n_local`` columns per rank (the main path's by default) at the main
    path's shard on ``variant``, by the composer's rule: one exchange per
    step (the variant's chunks, or one per rank where they do not cut the
    shard), and K1 per step only where the variant's M x N tile divides
    the step GEMM (else ``torch.matmul``)."""
    m_s = PREFILL_BATCH * PREFILL_SEQ // GROUP
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
        counts, routes = _check_launches(
            "autotune", "(e) DMA prefill on the promoted variant",
            _dma_launches(variant, sites))
        print(f"[autotune] (e) DMA prefill on the promoted variant "
              f"{variant.digest()}: launches {counts}; by route {routes}")
        check("(e) promoted DMA prefill", logits)


# The route every main-path launch of each kernel must take.
PATH_ROUTES = {"chunked_matmul": "wgmma", "accumulate_matmul": "wgmma",
               "a2a_chunk_exchange": "strided",
               "ficco_ag_matmul_fused": "wgmma"}


def _check_launches(label, what, expected):
    """Raise unless the launch counts since the last reset are ``expected``
    (0 for a kernel not named), each on its PATH_ROUTES route; returns the
    counts."""
    from repro_torch.kernels import ops

    counts, routes = ops.launch_counts(), ops.route_counts()
    want = {name: expected.get(name, 0) for name in counts}
    want_routes = {
        name: {r: expected.get(name, 0) if r == PATH_ROUTES[name] else 0
               for r in per_route}
        for name, per_route in routes.items()
    }
    if counts != want or routes != want_routes:
        raise AssertionError(f"[{label}] {what}: launches {counts} by route "
                             f"{routes}, expected {want} by route "
                             f"{want_routes}")
    return counts, routes


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
        counts, routes = _check_launches("prefill", label, expected)
        print(f"[prefill] {label}: launches in one prefill {counts} "
              f"({cfg.num_layers} layers x 2 projections x {GROUP} steps); "
              f"by route {routes}")
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


def _trace_events(prof) -> list:
    """(name, start us, end us, on the device) of each event ``prof``
    recorded, host and device, read straight from kineto's results:
    building ``prof.events()``' ``FunctionEvent``s for a run of 10^5
    launches takes minutes."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        out.append((ev.name(), start, start + ev.duration_ns() / 1e3,
                    ev.device_type() == cuda))
    return out


def phase_trace(label, run):
    """``run`` under torch.profiler, host and device: device time by kind,
    the device's idle share over the window (the first event to the last,
    host or device), how much of the copies' time ran under kernels
    (chunked_gemm.cu's and any) and every device event's time summed by
    :func:`_kind`.  Returns the numbers of kernel and memcpy events, the
    device's busy ms and its idle share; raises if the profiler saw no
    device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernels, k1, copies, window, names, kinds = [], [], [], [], set(), {}
    for name, start, end, on_device in _trace_events(prof):
        window += [start, end]
        if not on_device:
            continue
        n, us = kinds.get(_kind(name), (0, 0.0))
        kinds[_kind(name)] = (n + 1, us + end - start)
        if "memcpy" in name.lower():
            copies.append((start, end))
            names.add(name)
        else:
            kernels.append((start, end))
            if "chunked_gemm" in name:
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
    print(f"[trace] copy event names: {sorted(names)}")
    print(f"[trace] {label}: device time by kind: "
          + "; ".join(f"{kind} x{n} {us / 1e3:.2f} ms" for kind, (n, us)
                      in sorted(kinds.items(), key=lambda kv: -kv[1][1]))
          + f" (read in {time.perf_counter() - t0:.1f}s)")
    return {"kernels": len(kernels), "copies": len(copies),
            "busy_ms": busy_us / 1e3, "idle": 1 - busy_us / span}


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


# [adapt]: the online-adaptation tier on the card.  Request batches of
# ADAPT_BATCH requests (ADAPT_NEW new tokens each) whose prompt lengths
# drift upward; every third batch repeats the one before it (a memory
# hit).  ADAPT_PICKS batches are picked before the drift re-fit and after
# it.  While exploring, the policy's error bar is ADAPT_SIGMA (the
# reference's own drift test does the same): AdaptConfig.default_sigma
# also seeds the sentinel's residual scale, so widening it there would
# blind the sentinel.  The token bucket (ADAPT_BURST, no refill) bounds
# the measured sessions.
ADAPT_BATCH, ADAPT_NEW = 4, 16
ADAPT_PICKS = (24, 24)
ADAPT_BURST = 28
ADAPT_SIGMA = 10.0
ADAPT_TIERS = ("memory", "analytic", "measured", "heuristic")
ADAPT_REFIT_WAIT_S = 120.0
# (c): the sharded decode attention at a cache of DECODE_ATTN_CACHE,
# DECODE_ATTN_STEPS decode steps at its end.
DECODE_ATTN_CACHE, DECODE_ATTN_STEPS = 2048, 8


def _adapt_batches(cfg, n: int, seed: int) -> list:
    """``n`` batches of ADAPT_BATCH requests.  The j-th new batch's prompts
    are 32 + 64 j + 16 * {0..3} tokens (its total grows by 256 a batch, so
    every new batch is a new GEMM M); every third batch repeats the last."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    out, j = [], 0
    for i in range(n):
        if i % 3 == 2:
            out.append(out[-1])
            continue
        lens = 32 + 64 * j + 16 * rng.integers(0, 4, ADAPT_BATCH)
        out.append([Request(rng.integers(0, cfg.vocab_size, int(n_tok))
                            .astype(np.int32), max_new_tokens=ADAPT_NEW)
                    for n_tok in lens])
        j += 1
    return out


def _tokens(reqs) -> int:
    return sum(len(r.prompt) + r.max_new_tokens for r in reqs)


def _pcts(ms: list) -> str:
    if not ms:
        return "none"
    q = statistics.quantiles(ms, n=20, method="inclusive") if len(ms) > 1 \
        else [ms[0]] * 19
    return (f"{len(ms)} picks, p50 {statistics.median(ms):.4f} ms, "
            f"p95 {q[18]:.4f} ms")


def phase_adapt(device, cfg, state):
    """The serving tier on the card (``repro_torch.serve.adapt``), in a
    cache directory of its own: (a) ``AdaptiveTier`` with its re-fit
    thread, measured sessions timed by ``Autotuner.measure`` with CUDA
    events, the drift sentinel and its re-fit; (b) ``DecodeEngine(adapt=
    tier)`` against the same engine without it; (c) the sharded decode
    attention (``decode_attn="shard_map"``) against the plain decode."""
    from repro_torch.obs import audit

    t0 = time.perf_counter()
    outer = os.environ["REPRO_AUTOTUNE_CACHE_DIR"]
    with tempfile.TemporaryDirectory(prefix="adapt-") as cache_dir:
        os.environ["REPRO_AUTOTUNE_CACHE_DIR"] = cache_dir
        audit.enable_audit(os.path.join(cache_dir, "decisions-torch.jsonl"))
        try:
            tier = _adapt_tier(device, cfg)
            try:
                _adapt_engine(device, cfg, state, tier)
            finally:
                refitter = tier._refitter
                tier.stop()
                if refitter is not None and refitter.is_alive():
                    raise AssertionError("[adapt] the re-fit thread did not "
                                         "stop")
            _adapt_audit(audit.get_audit().path)
        finally:
            audit.disable_audit()
            os.environ["REPRO_AUTOTUNE_CACHE_DIR"] = outer
    _adapt_decode_attn(device, cfg, state)
    print(f"[adapt] phase total {time.perf_counter() - t0:.1f}s "
          f"({_card()})")


def _adapt_tier(device, cfg):
    """(a): the tier under drifting batches; returns it, still running."""
    import torch

    from repro_torch.core.machine import H100_SXM
    from repro_torch.core.schedule_types import Schedule
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics
    from repro_torch.parallel.sharding import shard_columns
    from repro_torch.serve.adapt import (
        AdaptConfig,
        AdaptiveTier,
        ExplorationPolicy,
    )

    randn = _randn_fn(device, 7)
    w = shard_columns(
        randn(D_MODEL, D_FF, dtype=torch.bfloat16, scale=D_MODEL ** -0.5),
        GROUP,
    )
    # The measured sessions time on a stream of their own: the re-fit
    # thread's fit runs on the card at the same time, on its default
    # stream, and must not fall between a session's two events.
    stream = torch.cuda.Stream(device)
    sessions = []

    def measure(gemm, candidates, profile):
        """The measured tier's hook (``measure_fn``): the batch's FFN
        GEMM as stacked shards, each candidate timed by the tier's
        ``Autotuner.measure`` (CUDA events, min of 3 after a warm-up),
        which records the winner for the machine re-fit.  The schedules
        are uniform: the profile only keys the decision."""
        x = randn(GROUP, gemm.m // GROUP, gemm.k, dtype=torch.bfloat16)
        stream.wait_stream(torch.cuda.current_stream(device))
        t1 = time.perf_counter()
        with torch.cuda.stream(stream):
            dec = tier.tuner.measure(x, w, machine=tier.machine,
                                     schedules=candidates)
        times = {Schedule(s): t for s, t in dec.shortlist}
        sessions.append({"m": gemm.m, "candidates": list(candidates),
                         "times": times,
                         "host_s": time.perf_counter() - t1})
        return times

    metrics.reset_metrics()
    reg = metrics.get_metrics()
    tier = AdaptiveTier(
        machine=H100_SXM, group=GROUP, device=device, measure_fn=measure,
        config=AdaptConfig(explore_rate=0.0, explore_burst=ADAPT_BURST,
                           refit_interval_s=3600.0, refit_min_picks=8),
    )
    # What the default error bar would have granted on the same rankings.
    shadow = ExplorationPolicy(AdaptConfig(explore_rate=0.0,
                                           explore_burst=ADAPT_BURST))
    explore = tier.policy.should_measure

    def both(ranked):
        shadow.should_measure(ranked)
        return explore(ranked)

    tier.policy.should_measure = both
    tier.policy.set_sigma(ADAPT_SIGMA)
    batches = _adapt_batches(cfg, sum(ADAPT_PICKS), seed=8)
    lat = {t: [] for t in ADAPT_TIERS}
    picks = []

    def pick(reqs):
        before = {t: reg.counter(f"serve/adapt.pick.{t}").value
                  for t in ADAPT_TIERS}
        t1 = time.perf_counter()
        dec = tier.pick_for_requests(reqs, cfg)
        ms = (time.perf_counter() - t1) * 1e3
        (which,) = [t for t in ADAPT_TIERS
                    if reg.counter(f"serve/adapt.pick.{t}").value
                    != before[t]]
        lat[which].append(ms)
        picks.append(which)
        if not isinstance(dec.schedule, Schedule):
            raise AssertionError(f"[adapt] pick served no schedule: {dec}")

    ops.reset_launch_counts()
    tier.start()
    t_drive = time.perf_counter()
    for reqs in batches[:ADAPT_PICKS[0]]:
        pick(reqs)
    sentinel = tier.sentinel
    alarmed = sentinel.alarms > 0
    waited = 0.0
    if alarmed:
        # The alarm kicked the re-fit thread; wait for its cycle.
        t1 = time.perf_counter()
        while sentinel.refits < 1:
            if time.perf_counter() - t1 > ADAPT_REFIT_WAIT_S:
                raise AssertionError("[adapt] the drift re-fit did not run "
                                     f"within {ADAPT_REFIT_WAIT_S}s")
            time.sleep(0.01)
        waited = time.perf_counter() - t1
    n_before = len(sessions)
    tier.policy.set_sigma(ADAPT_SIGMA)  # re-open the measured tier
    for reqs in batches[ADAPT_PICKS[0]:]:
        pick(reqs)
    # A later alarm kicks another cycle: let it finish before (b).
    t1 = time.perf_counter()
    while sentinel.should_refit() or sentinel.refits < sentinel.alarms:
        if time.perf_counter() - t1 > ADAPT_REFIT_WAIT_S:
            raise AssertionError("[adapt] a re-fit did not finish within "
                                 f"{ADAPT_REFIT_WAIT_S}s")
        time.sleep(0.01)
    waited += time.perf_counter() - t1
    torch.cuda.synchronize(device)
    drive_s = time.perf_counter() - t_drive
    counts = ops.launch_counts()

    by_tier = {t: picks.count(t) for t in ADAPT_TIERS}
    print(f"[adapt] (a) AdaptiveTier(H100_SXM, group {GROUP}) with its re-fit"
          f" thread: {len(picks)} picks of {ADAPT_BATCH}-request batches "
          f"(FFN GEMM M x {D_FF} x {D_MODEL}, M = the batch's tokens, "
          f"{_tokens(batches[0])}..{_tokens(batches[-1])}) in "
          f"{drive_s:.2f}s ({waited:.2f}s of it waiting for re-fits); "
          f"by tier {by_tier}")
    for t in ADAPT_TIERS:
        print(f"[adapt] (a) pick latency, {t}: {_pcts(lat[t])}")
    print(f"[adapt] (a) policy at sigma {ADAPT_SIGMA}: ambiguous "
          f"{tier.policy.ambiguous}, granted {tier.policy.granted}, denied "
          f"{tier.policy.denied}; the default sigma "
          f"{AdaptConfig().default_sigma} on the same rankings: ambiguous "
          f"{shadow.ambiguous}, granted {shadow.granted}, denied "
          f"{shadow.denied}")
    n2d = sum(Schedule.UNIFORM_FUSED_2D in s["candidates"] for s in sessions)
    pairs, winners = {}, {}
    for s in sessions:
        pair = " + ".join(c.value for c in s["candidates"])
        win = min(s["times"], key=s["times"].get).value
        pairs[pair] = pairs.get(pair, 0) + 1
        winners[win] = winners.get(win, 0) + 1
    print(f"[adapt] (a) {len(sessions)} measured sessions ({n_before} before"
          f" the re-fit), winner ms (CUDA events): "
          + ", ".join(f"M{s['m']} {min(s['times'].values()) * 1e3:.4f}"
                      for s in sessions)
          + f"; candidates {pairs}, winners {winners}; host s per session p50 "
          f"{statistics.median(s['host_s'] for s in sessions):.4f}; "
          f"{n2d} timed uniform-fused-2d: K2 launches "
          f"{counts['accumulate_matmul']}; launches {counts}")
    if by_tier["heuristic"] or reg.counter(
            "serve/adapt.pick.heuristic").value:
        raise AssertionError("[adapt] a pick fell back to the heuristic")
    n_measures = reg.counter("serve/adapt.measures").value
    if n_measures < 6 or n_measures != len(sessions) or by_tier[
            "measured"] != len(sessions):
        raise AssertionError(f"[adapt] measured sessions {len(sessions)}, "
                             f"serve/adapt.measures {n_measures}, measured "
                             f"picks {by_tier['measured']}")
    for s in sessions:  # every candidate runs at these shapes
        if set(s["times"]) != set(s["candidates"]) or not all(
                math.isfinite(t) and t > 0 for t in s["times"].values()):
            raise AssertionError(f"[adapt] session timed {s['times']} of "
                                 f"{s['candidates']}")
    # 4 runs (a warm-up and 3 timed) x GROUP K-slice steps per 2D session.
    if counts["accumulate_matmul"] != 4 * GROUP * n2d:
        raise AssertionError(f"[adapt] K2 launches {counts} for {n2d} "
                             "sessions that timed uniform-fused-2d")

    st = sentinel.state()
    print(f"[adapt] (a) sentinel: {st}")
    events = sentinel.events
    refit = [e for e in events if e["kind"] == "sentinel_refit"]
    recovery = [e for e in events if e["kind"] == "sentinel_recovery"]
    if alarmed:
        rep = refit[0]["report"] if refit else {}
        if not refit or refit[0]["trigger"] != "drift" or "link_bw" not in \
                rep.get("fit_deployed", ""):
            raise AssertionError(f"[adapt] the alarm's re-fit: {refit}")
        if tier.machine.link_bw == H100_SXM.link_bw or (
                H100_SXM.link_bw != 450e9):
            raise AssertionError("[adapt] link_bw not deployed")
        print(f"[adapt] (a) drift re-fit: trigger {refit[0]['trigger']}, "
              f"channel {refit[0]['channel']}, {rep.get('fit_records')} "
              f"records, fit_sigma {rep.get('fit_sigma'):.4f}, link_bw "
              f"{H100_SXM.link_bw / 1e9:.2f} -> "
              f"{tier.machine.link_bw / 1e9:.4f} GB/s "
              f"(x {tier.machine.link_bw / H100_SXM.link_bw:.4f}), "
              f"deployed {rep.get('fit_deployed')}; the module's H100_SXM "
              f"keeps {H100_SXM.link_bw / 1e9:.0f} GB/s")
    else:
        print("[adapt] (a) the sentinel did not alarm: no drift re-fit")
    if recovery:
        r = recovery[0]
        print(f"[adapt] (a) recovery after {r['samples']} residuals: "
              f"post_mean {r['post_mean']:.4f}, post_rms {r['post_rms']:.4f}"
              f" against the pre-refit EWMA {r['pre_refit_ewma']:.4f} "
              f"(ratio {r['post_mean'] / r['pre_refit_ewma']:.4f})")
    elif alarmed:
        print("[adapt] (a) no recovery event: fewer than "
              f"{sentinel.config.min_samples} residuals after the re-fit")
    print(f"[adapt] (a) gate: version {tier.gate_version}, agreement on its "
          f"live grid {tier.last_agreement}; stats {tier.stats()}")
    return tier


def _adapt_audit(path: str) -> None:
    from repro_torch.obs import audit, sentinel

    recs = audit.read_audit(path)
    kinds = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    errors = audit.validate_audit(recs) + sentinel.validate_sentinel(
        [r for r in recs if r["kind"].startswith("sentinel_")])
    if errors or not kinds.get("adapt_measure"):
        raise AssertionError(f"[adapt] audit records {kinds}: {errors[:5]}")
    print(f"[adapt] audit log: {len(recs)} records {kinds}, all valid")


def _adapt_engine(device, cfg, state, tier):
    """(b): DecodeEngine with the tier against the same engine without it,
    in turns."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    from repro_torch.serve.engine import DecodeEngine, Request

    prompts, prompt_len, cache_len, n_batches = 4, 8, 128, 3
    rng = np.random.default_rng(9)
    raws = [rng.integers(0, cfg.vocab_size, (prompts, prompt_len + 4 * b))
            for b in range(n_batches)]
    steps = []

    def answer(raw, adapt):
        eng = DecodeEngine(cfg, state, batch_size=prompts,
                           cache_len=cache_len, device=device, adapt=adapt)
        step = eng.step_fn

        def counted(*args):
            steps.append(1)
            return step(*args)

        eng.step_fn = counted
        reqs = [Request(r.astype(np.int32), max_new_tokens=ADAPT_NEW)
                for r in raw]
        t1 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize(device)
        return eng, [r.out for r in out], time.perf_counter() - t1

    answer(raws[0], None)  # warm
    ops.reset_launch_counts()
    tracer = trace.enable()
    per_step = {"with": [], "without": []}
    try:
        for raw in raws:
            for label, adapt in (("without", None), ("with", tier),
                                 ("with", tier), ("without", None)):
                steps.clear()
                eng, toks, dt = answer(raw, adapt)
                per_step[label].append(dt * 1e3 / len(steps))
                if label == "with":
                    got, dec = toks, eng.last_decision
                else:
                    want = toks
            if got != want or sum(map(len, got)) != prompts * ADAPT_NEW:
                raise AssertionError("[adapt] (b) the tier changed the "
                                     "tokens")
    finally:
        trace.disable()
    runs = [e for e in tracer.events if e["name"] == "serve/run"]
    tagged = [e for e in runs if "overlap_schedule" in e["args"]]
    if len(tagged) != 2 * n_batches or len(runs) != 4 * n_batches:
        raise AssertionError(f"[adapt] (b) serve/run spans {runs}")
    print(f"[adapt] (b) DecodeEngine(adapt=tier), {n_batches} batches of "
          f"{prompts} requests x {ADAPT_NEW} new tokens (cache {cache_len}),"
          f" in turns: ms per step with the tier "
          + ", ".join(f"{t:.3f}" for t in per_step["with"])
          + " / without " + ", ".join(f"{t:.3f}" for t in per_step["without"])
          + f" (medians {statistics.median(per_step['with']):.3f} / "
          f"{statistics.median(per_step['without']):.3f}); tokens equal; "
          f"serve/run carries overlap_schedule "
          f"{tagged[-1]['args']['overlap_schedule']} "
          f"({tagged[-1]['args']['overlap_tier']}); last decision "
          f"{dec.schedule.value} ({dec.source}); launches "
          f"{ops.launch_counts()}")


def _adapt_decode_attn(device, cfg, state):
    """(c): TinyLlama-1.1B's decode with ``decode_attn="shard_map"`` on a
    group of GROUP ranks, at a cache of DECODE_ATTN_CACHE filled with
    random keys and values, against the plain decode on the same cache."""
    import torch

    from repro_torch.configs.base import OverlapConfig
    from repro_torch.models.model import build_model
    from repro_torch.parallel import decode_attn
    from repro_torch.parallel.context import overlap_context
    from repro_torch.parallel.sharding import TPGroup, tp_group
    from repro_torch.tree import leaves

    prompts, s = 4, DECODE_ATTN_CACHE
    plain_cfg = dataclasses.replace(cfg, overlap=OverlapConfig())
    sharded_cfg = dataclasses.replace(
        cfg, overlap=OverlapConfig(decode_attn="shard_map"))
    plain, sharded = build_model(plain_cfg), build_model(sharded_cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(10)
    caches = [plain.init_cache(prompts, s, device=device)]
    for c in caches[0]:
        for t in c.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=device))
    caches.append([{k: t.clone() for k, t in c.items()} for c in caches[0]])
    toks = torch.randint(0, cfg.vocab_size, (prompts, DECODE_ATTN_STEPS),
                         generator=gen, device=device)
    group = TPGroup(GROUP, device)
    calls = []
    real = decode_attn.shard_map_attn_decode

    def counted(*args):
        calls.append(1)
        return real(*args)

    def step(which, i):
        pos = s - DECODE_ATTN_STEPS + i
        if which == "plain":
            return plain.decode_step(state, caches[0], toks[:, i:i + 1],
                                     pos)[0]
        with tp_group(group), overlap_context(sharded_cfg.overlap):
            return sharded.decode_step(state, caches[1], toks[:, i:i + 1],
                                       pos)[0]

    decode_attn.shard_map_attn_decode = counted
    try:
        with torch.no_grad():
            errs, scale = [], 0.0
            for i in range(DECODE_ATTN_STEPS):
                want, got = step("plain", i), step("sharded", i)
                scale = max(scale, want.float().abs().max().item())
                errs.append(_max_err(got, want))
                if not torch.isfinite(got).all():
                    raise AssertionError("[adapt] (c) non-finite logits")
            n_calls = len(calls)
            if n_calls != cfg.num_layers * DECODE_ATTN_STEPS:
                raise AssertionError(f"[adapt] (c) {n_calls} sharded "
                                     "decode attention calls")
            ms = {}
            for which in ("plain", "sharded", "sharded", "plain"):
                ms.setdefault(which, []).append(wall_ms(
                    lambda w=which: step(w, DECODE_ATTN_STEPS - 1)))
    finally:
        decode_attn.shard_map_attn_decode = real
    if max(errs) > 5e-2 * scale:
        raise AssertionError(f"[adapt] (c) sharded decode differs by "
                             f"{max(errs)} (max |logit| {scale})")
    weight_bytes = _nbytes(*leaves(state))
    cache_bytes = sum(_nbytes(*c.values()) for c in caches[0])
    bound = (weight_bytes + cache_bytes) / PEAK_BYTES * 1e3
    print(f"[adapt] (c) decode_attn=\"shard_map\" on {GROUP} ranks, "
          f"{prompts} requests at a cache of {s} ({cache_bytes / 2 ** 20:.1f}"
          f" MiB): {n_calls} sharded calls over {DECODE_ATTN_STEPS} steps;"
          f" per-step logits max_abs_err {max(errs):.4e} of max |logit| "
          f"{scale:.4f} ({max(errs) / scale:.2e}); ms per step (host wall, "
          f"median of 5, in turns) plain "
          + ", ".join(f"{t:.3f}" for t in ms["plain"]) + " / sharded "
          + ", ".join(f"{t:.3f}" for t in ms["sharded"])
          + f" against a byte bound of {bound:.3f} ms "
          f"({(weight_bytes + cache_bytes) / 1e9:.3f} GB at "
          f"{PEAK_BYTES / 1e12:.2f} TB/s)")


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
            counts, _ = _check_launches("train", f"{label} step {i + 1}",
                                        expected)
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


# [sweep]: the card-resident design-space sweep at the reference's scale
# ("a 1e8-lane sweep on the device"): synthesis held against the numpy
# host twins, the mixed engine against the "torch" engine, the fused
# sweep against the host pipeline, then 1e8 scenarios x machine_grid() in
# float32 in SWEEP_SHARDS shards (4e6 lanes each keep the (M, L, S)
# outputs near 1.2 GB apiece).
SWEEP_SYNTH, SWEEP_SYNTH_RAGGED = 10_000_000, 1_000_000
SWEEP_ENGINE, SWEEP_HOST, SWEEP_RUNNER = 100_000, 1_000_000, 200_000
SWEEP_FULL, SWEEP_SHARDS = 100_000_000, 25
SWEEP_CLI = 1_000_000
SWEEP_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
SWEEP_ATOL = {"float32": 0.0, "bfloat16": 1e-4}
GRID_FIELDS = ("total", "comm_busy", "compute_busy", "exposed", "steps",
               "valid", "serial_comm", "serial_gemm")


def _same_grid(label, got, want):
    import numpy as np

    for f in GRID_FIELDS:
        if not np.array_equal(getattr(got, f), getattr(want, f),
                              equal_nan=f not in ("steps", "valid")):
            raise AssertionError(f"[sweep] {label}: {f} differs")


def _same_stats(label, got, want):
    import numpy as np

    if not (np.array_equal(got.hist, want.hist)
            and got.best_counts == want.best_counts
            and got.n_points == want.n_points):
        raise AssertionError(
            f"[sweep] {label}: statistics differ ({got.n_points} vs "
            f"{want.n_points} points, best {got.best_counts} vs "
            f"{want.best_counts}, {int((got.hist != want.hist).sum())} "
            "histogram cells)")


def phase_sweep(device):
    """The card-resident sweep (``repro_torch.sweep.device``): (a) on-card
    synthesis against the numpy host twins, (b) the ``"mixed"`` engine
    against the ``"torch"`` engine with its dispatch under the sync
    debug mode's "error", (c) the fused float64 sweep against the host
    pipeline, (d) the fused float32 sweep at SWEEP_FULL scenarios with
    and without ``overlap_dispatch``, one shard profiled, (e) the runner's
    ``device_parallel`` and two-phase mixed shards against eager runs,
    (f) ``device_merge_stats`` against the host fold, (g) the sweep and
    merge command lines."""
    import functools
    import warnings

    import numpy as np
    import torch

    from repro_torch.core.engine import MixedEngine, TorchEngine
    from repro_torch.core.workload import machine_grid
    from repro_torch.learn.stats import GateStats, sweep_stats
    from repro_torch.sweep import (
        device_batch,
        device_merge_stats,
        device_ragged_batch,
        host_batch,
        host_ragged_batch,
        sweep_device_stats,
        sweep_grid,
        synthetic_batch,
    )
    from repro_torch.sweep import device as sweep_dev

    card = _card()
    t_phase = time.time()
    machines = machine_grid()
    M = len(machines)

    # (a) synthesis: integers and masks exact, fractions within 1e-14.
    def synth(n, ragged):
        lane = sweep_dev._lanes(n, 0, device)
        out = sweep_dev._synth_uniform(lane, 11, (2, 1))
        return out + ((sweep_dev._synth_frac(lane, 11, 8, 0.7),)
                      if ragged else ())

    for n, ragged in ((SWEEP_SYNTH, False), (SWEEP_SYNTH_RAGGED, True)):
        synth(n, ragged)  # the allocator's first growth is not timed
        _, t_card = _timed(lambda: synth(n, ragged))
        if ragged:
            got = device_ragged_batch(n, seed=11, device=device)
            want, t_host = _timed(lambda: host_ragged_batch(n, seed=11))
        else:
            got = device_batch(n, seed=11, device=device)
            want, t_host = _timed(lambda: host_batch(n, seed=11))
        for f in ("m", "n", "k", "dtype_bytes"):
            differ = int((getattr(got, f) != getattr(want, f)).sum())
            if differ:
                raise AssertionError(f"[sweep] synthesis: {f} differs at "
                                     f"{differ} lanes")
        extra = ""
        if ragged:
            if not np.array_equal(got.frac == 0.0, want.frac == 0.0):
                raise AssertionError("[sweep] synthesis: zero masks differ")
            gap = np.abs(got.frac - want.frac).max(axis=1)
            far = int((gap > 1e-14).sum())
            extra = (f"; zero masks equal; largest fraction gap "
                     f"{gap.max():.3e}, {far} lanes beyond 1e-14, "
                     f"{float((got.frac == want.frac).mean()):.4f} of "
                     "fractions bit-equal")
            if far:
                raise AssertionError(f"[sweep] synthesis: {far} lanes' "
                                     "fractions beyond 1e-14")
        print(f"[sweep] (a) {'ragged (8 steps)' if ragged else 'uniform'} "
              f"synthesis of {n} lanes: integers equal at every lane{extra};"
              f" {n / t_card:.4g} lanes/s on the card ({t_card * 1e3:.1f} "
              f"ms, left there), {n / t_host:.4g} lanes/s for the numpy "
              f"twin on the host ({t_host:.2f} s) [{card}]")

    # (b) the mixed engine: float64 bit-equal to "torch", reduced
    # precision within the reference's tolerances; dispatch queues
    # without a synchronisation.
    batch = synthetic_batch(SWEEP_ENGINE, seed=0)
    on_card = TorchEngine(device)
    on_card.evaluate(synthetic_batch(1000, seed=5), machines)
    want, t_want = _timed(lambda: on_card.evaluate(batch, machines))
    points = SWEEP_ENGINE * M
    for dtype in ("float64", "float32", "bfloat16"):
        eng = MixedEngine(dtype, device=device)
        eng.evaluate(synthetic_batch(1000, seed=5), machines)
        _sync()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            finalize = eng.dispatch(batch, machines)
            t_issue = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = finalize()
        t_all = time.perf_counter() - t0
        if dtype == "float64":
            _same_grid("mixed float64 vs torch", got, want)
            what = "bit-equal to the torch engine's grid"
        else:
            if not np.array_equal(got.valid, want.valid):
                raise AssertionError(f"[sweep] mixed {dtype}: valid differs")
            a, b = got.total[got.valid], want.total[want.valid]
            rel = float((np.abs(a - b) / np.abs(b)).max())
            if not np.allclose(a, b, rtol=SWEEP_RTOL[dtype],
                               atol=SWEEP_ATOL[dtype]):
                raise AssertionError(f"[sweep] mixed {dtype}: totals beyond "
                                     f"rtol {SWEEP_RTOL[dtype]}")
            what = (f"valid masks equal, largest relative gap of totals "
                    f"{rel:.3e} (rtol {SWEEP_RTOL[dtype]:g}, atol "
                    f"{SWEEP_ATOL[dtype]:g})")
        print(f"[sweep] (b) MixedEngine({dtype}) on {SWEEP_ENGINE} scenarios "
              f"x {M} machines: {what}; dispatch queued in "
              f"{t_issue * 1e3:.1f} ms with no synchronisation (sync debug "
              f"mode \"error\"), {t_all * 1e3:.1f} ms with the grid on the "
              f"host ({points / t_all:.4g} points/s; the torch engine "
              f"{points / t_want:.4g}) [{card}]")

    # (c) the fused float64 sweep against the host pipeline on the same
    # lanes: the torch engine's grids folded by GateStats on the host.
    fused, t_fused = _timed(lambda: sweep_device_stats(
        SWEEP_HOST, machines, seed=3, dtype="float64", num_shards=4,
        device=device)[0])
    host, t_hostp = _timed(lambda: sweep_stats(
        host_batch(SWEEP_HOST, seed=3), machines, engine=on_card,
        num_shards=10)[0])
    _same_stats("fused float64 vs host pipeline", fused, host)
    print(f"[sweep] (c) fused float64 sweep of {SWEEP_HOST} lanes x {M} "
          f"machines on the card ({t_fused:.2f} s) vs sweep_stats on the "
          f"torch engine + GateStats on the host ({t_hostp:.2f} s): "
          f"histogram ({int((host.hist != 0).sum())} cells hit) and "
          f"best_counts {fused.best_counts} equal [{card}]")

    # (d) the fused float32 sweep at full size, with and without the
    # double-buffered dispatch (in turns), one shard profiled.
    sweep_device_stats(100_000, machines, dtype="float32", device=device)
    runs = {}
    for overlap in (True, False):
        torch.cuda.reset_peak_memory_stats(device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                (stats, res), wall = _timed(lambda: sweep_device_stats(
                    SWEEP_FULL, machines, dtype="float32",
                    num_shards=SWEEP_SHARDS, overlap_dispatch=overlap,
                    device=device))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        runs.setdefault(overlap, []).append((stats, res, wall))
        print(f"[sweep] (d) fused float32 sweep, {SWEEP_FULL} scenarios x "
              f"{M} machines in {SWEEP_SHARDS} shards, overlap_dispatch="
              f"{overlap}: {wall:.2f} s wall, {SWEEP_FULL / wall:.4g} "
              f"scenarios/s, {SWEEP_FULL * M / wall:.4g} points/s; shard "
              f"seconds p50 "
              f"{statistics.median(s.seconds for s in res.summaries):.3f}; "
              f"peak memory {peak:.2f} GB; {syncs} synchronising calls "
              f"flagged by the sync debug mode [{card}]")
    base = runs[True][0]
    for stats, res, _ in runs[False]:
        _same_stats("overlap_dispatch on vs off", stats, base[0])
        if ([s.best_counts for s in res.summaries]
                != [s.best_counts for s in base[1].summaries]):
            raise AssertionError("[sweep] per-shard best_counts differ")
    st = base[0]
    print(f"[sweep] (d) the two runs' statistics identical: "
          f"{st.n_points} points, best_counts {st.best_counts}, "
          f"{int((st.hist != 0).sum())} histogram cells hit [{card}]")
    shard = SWEEP_FULL // SWEEP_SHARDS
    tr = phase_trace(f"sweep shard ({shard} lanes x {M} machines, float32)",
                     lambda: sweep_device_stats(shard, machines,
                                                dtype="float32",
                                                device=device))
    print(f"[sweep] (d) one profiled shard: device busy "
          f"{tr['busy_ms']:.2f} ms, idle share {tr['idle']:.3f}, "
          f"{tr['kernels']} kernels [{card}]")

    # (e) the runner: device_parallel over the visible cards and the
    # mixed engine's two-phase shards, each against its eager run.
    rb = synthetic_batch(SWEEP_RUNNER, seed=4)
    eager, t_eager = _timed(lambda: sweep_grid(rb, machines, engine=on_card,
                                               num_shards=4))
    dpar, t_dpar = _timed(lambda: sweep_grid(rb, machines,
                                             device_parallel=True,
                                             num_shards=4))
    _same_grid("device_parallel vs eager", dpar.grid, eager.grid)
    eng32 = MixedEngine("float32", device=device)
    runs_e = {}
    for overlap in (False, True):
        runs_e[overlap] = _timed(lambda: sweep_grid(
            rb, machines, engine=eng32, num_shards=8,
            overlap_dispatch=overlap))
    _same_grid("mixed float32 two-phase vs eager", runs_e[True][0].grid,
               runs_e[False][0].grid)
    print(f"[sweep] (e) sweep_grid over {SWEEP_RUNNER} scenarios: "
          f"device_parallel on {torch.cuda.device_count()} card(s) "
          f"{t_dpar:.2f} s bit-equal to the eager torch engine "
          f"{t_eager:.2f} s; MixedEngine(float32) in 8 shards, "
          f"overlap_dispatch {runs_e[True][1]:.2f} s vs eager "
          f"{runs_e[False][1]:.2f} s, grids identical [{card}]")

    # (f) the merge on the card against the host fold.
    parts = [sweep_device_stats(20_000, machines, seed=40 + i,
                                ragged=i == 1, device=device)[0]
             for i in range(3)]
    merged = device_merge_stats(parts, device=device)
    fold = functools.reduce(GateStats.merge, parts)
    _same_stats("device_merge_stats vs host fold", merged, fold)
    if not np.array_equal(merged.moments, fold.moments):
        raise AssertionError("[sweep] merged moments differ")
    print(f"[sweep] (f) device_merge_stats of 3 statistics "
          f"({merged.n_points} points) identical to the host fold "
          f"[{card}]")

    # (g) the command lines: a sweep on the mixed engine, then its merge.
    with tempfile.TemporaryDirectory(prefix="sweep-") as tmp:
        out = os.path.join(tmp, "sweep.jsonl")
        env = dict(os.environ, PYTHONPATH=SRC)
        for args in (
                ["repro_torch.scripts.sweep", "--scenarios", str(SWEEP_CLI),
                 "--shards", "8", "--backend", "mixed", "--dtype",
                 "float32", "--synth-device", "--overlap-dispatch",
                 "--device", str(device), "--out", out],
                ["repro_torch.scripts.merge_sweep", out, "--strict",
                 "--out", os.path.join(tmp, "merged.json")]):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", *args],
                                  capture_output=True, text=True,
                                  timeout=300, env=env)
            if proc.returncode != 0:
                raise AssertionError(f"[sweep] {args[0]} exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            last = proc.stderr.strip().splitlines()[-1]
            print(f"[sweep] (g) python -m {args[0]}: exit 0 in "
                  f"{time.perf_counter() - t0:.1f} s; {last} [{card}]")
        with open(os.path.join(tmp, "merged.json")) as f:
            summary = json.load(f)
        if not (summary["complete"] and summary["n_scenarios"] == SWEEP_CLI
                and summary["dtype"] == "float32"):
            raise AssertionError(f"[sweep] merged summary {summary}")
    print(f"[sweep] phase total {time.time() - t_phase:.1f}s")


# [dryrun]: the caching allocator rounds each block up to a multiple of
# 512 bytes.  It also hands out a whole large segment when what would be
# left of it is 1 MB or less, unless its segments are expandable; so
# (b) allocates with expandable segments, and sets them back after.
ALLOC_ROUND = 512


def phase_dryrun(device):
    """The dry-run (``repro_torch.launch.dryrun``), host arithmetic on
    meta tensors: (a) every arch x shape on the production meshes, each
    ``ok``; (b) one device's shard of every argument leaf of the largest
    training state allocated on the card, the allocator's growth held to
    the dry-run's argument bytes; (c) the dry-run and hillclimb command
    lines, each exiting 0."""
    import warnings

    import torch

    from repro_torch.configs import ARCHS, SHAPES, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, make_production_mesh

    t_phase = time.time()
    card = _card()
    results = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.perf_counter()
        for arch in sorted(ARCHS):
            for shape in SHAPES:
                r = dryrun.dryrun_one(arch, shape, multi_pod=multi_pod,
                                      extrapolate=False, verbose=False)
                if not r.get("ok"):
                    raise AssertionError(f"[dryrun] {arch} x {shape} on "
                                         f"{mesh.name}: {r}")
                results[arch, shape, mesh.name] = r
        print(f"[dryrun] (a) {len(ARCHS) * len(SHAPES)} pairs on "
              f"{mesh.name} ({mesh.size} devices) ok in "
              f"{time.perf_counter() - t0:.2f} s of host")
    for (arch, shape, mesh_name), r in results.items():
        counts = " ".join(f"{k}:{v}" for k, v in
                          sorted(r["collective_counts"].items()))
        print(f"[dryrun]   {arch:22s} {shape:12s} {mesh_name:8s} "
              f"{r['bytes_per_device'] / 1e9:9.3f} GB/device, compute "
              f"{r['t_compute'] * 1e3:10.3f} ms, memory "
              f"{r['t_memory'] * 1e3:9.3f} ms, collective "
              f"{r['t_collective'] * 1e3:8.3f} ms ({counts})")
    # The count at the shapes of the reference's compiled steps (the
    # reduced configs at seq 64, batch 8 on (data 2, model 2)), which
    # PERF.md sets beside what GSPMD inserted there.
    small = Mesh(("data", "model"), (2, 2))
    for arch in ("tinyllama-1.1b", "xlstm-1.3b"):
        for kind in ("prefill", "train"):
            cfg = get_config(arch).reduced()
            shape = ShapeConfig("t", 64, 8, kind)
            args = dryrun.step_arguments(cfg, shape, small)
            coll = dryrun.step_collectives(cfg, shape, small, args)
            kinds = ", ".join(
                f"{k} {coll.bytes_by_kind[k]:.0f} B in "
                f"{coll.count_by_kind[k]}" for k in sorted(coll.count_by_kind))
            print(f"[dryrun] (a) reduced {arch} {kind} at (2, 2), seq 64, "
                  f"batch 8: arguments {dryrun.per_device_bytes(args, small)}"
                  f" B; {kinds}")

    # (b) the largest training state's per-device shard on the card.
    mesh = make_production_mesh()
    arch, shape = max(
        ((a, s) for a, s, m in results
         if m == mesh.name and SHAPES[s].kind == "train"),
        key=lambda k: results[k[0], k[1], mesh.name]["argument_bytes"])
    predicted = results[arch, shape, mesh.name]["argument_bytes"]
    cfg = dryrun.prepared_config(arch, SHAPES[shape], "gspmd_serial")
    args = dryrun.step_arguments(cfg, SHAPES[shape], mesh)
    shards = dryrun.shard_leaves(args, mesh)
    if dryrun.per_device_bytes(args, mesh) != predicted:
        raise AssertionError("[dryrun] (b) step_arguments disagree with "
                             "dryrun_one")

    def requested():
        return torch.cuda.memory_stats(device).get(
            "requested_bytes.all.current")

    def expandable(on: bool):
        with warnings.catch_warnings():  # deprecated in torch 2.11
            warnings.simplefilter("ignore", FutureWarning)
            torch.cuda.memory._set_allocator_settings(
                f"expandable_segments:{on}")

    _sync()
    torch.cuda.empty_cache()
    expandable(True)
    try:
        before, asked = torch.cuda.memory_allocated(device), requested()
        bufs = [torch.zeros(s, dtype=dt, device=device) for s, dt in shards]
        _sync()
        grown = torch.cuda.memory_allocated(device) - before
        if asked is not None:
            asked = requested() - asked
        del bufs
        torch.cuda.empty_cache()
    finally:
        expandable(False)
    slack = ALLOC_ROUND * len(shards)
    print(f"[dryrun] (b) {arch} x {shape} on {mesh.name}: one device's "
          f"{len(shards)} argument leaves (params, m, v, step, batch) "
          f"allocated on the card: memory_allocated grew {grown} B against "
          f"the dry-run's {predicted} B ({grown / 1e9:.3f} GB; difference "
          f"{grown - predicted} B, allowed 0..{slack}); requested bytes "
          f"grew {asked} B [{card}]")
    if not predicted <= grown <= predicted + slack:
        raise AssertionError(f"[dryrun] (b) allocated {grown} B for "
                             f"{predicted} B predicted")
    if asked is not None and asked != predicted:
        raise AssertionError(f"[dryrun] (b) requested {asked} B for "
                             f"{predicted} B predicted")

    # (c) the command lines.
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        out = os.path.join(tmp, "dryrun.json")
        env = dict(os.environ, PYTHONPATH=SRC)
        for args in (
                ["repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b",
                 "--shape", "train_4k", "--json", out],
                ["repro_torch.scripts.hillclimb", "--pair", "yi_decode"]):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", *args],
                                  capture_output=True, text=True,
                                  timeout=300, env=env)
            if proc.returncode != 0:
                raise AssertionError(f"[dryrun] {args[0]} exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            last = proc.stdout.strip().splitlines()[-1]
            print(f"[dryrun] (c) python -m {' '.join(args[:3])}: exit 0 "
                  f"in {time.perf_counter() - t0:.1f} s; {last.strip()}")
        with open(out) as f:
            rows = json.load(f)
        want = results["tinyllama-1.1b", "train_4k", mesh.name]
        if not (len(rows) == 1 and rows[0]["ok"]
                and rows[0]["bytes_per_device"] == want["bytes_per_device"]):
            raise AssertionError(f"[dryrun] (c) the command line's JSON "
                                 f"{rows}")
    print(f"[dryrun] phase total {time.time() - t_phase:.1f}s")


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


def _answer_requests(label, cfg, state, device, raw, new_tokens: int,
                     cache_len: int, *, enc_len: int = 0, frames=None):
    """``DecodeEngine`` answers one request per row of ``raw`` (prompts),
    ``new_tokens`` each; an encoder-decoder's cross K/V first filled from
    ``frames`` by ``prefill_cross``.  The engine runs the requests twice:
    the first run pays one-time set-up, the second is timed (host clock,
    synchronised) and must give the first's tokens (ROADMAP R7: each run
    starts from the recurrent layers' initial state).  Raises unless every
    request got its tokens.  Returns (engine, requests, seconds and decode
    steps of the timed run, seconds of the first)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import DecodeEngine, Request

    eng = DecodeEngine(cfg, state, batch_size=len(raw), cache_len=cache_len,
                       enc_len=enc_len, device=device)
    if frames is not None:
        with torch.no_grad():
            eng.cache = eng.model.prefill_cross(state, eng.cache, frames)
    steps, step = [], eng.step_fn

    def counted(*args):
        steps.append(1)
        return step(*args)

    eng.step_fn = counted

    def run():
        steps.clear()
        reqs = [Request(p.astype(np.int32), max_new_tokens=new_tokens)
                for p in raw]
        _sync()
        t0 = time.perf_counter()
        out = eng.run(reqs)
        _sync()
        return out, time.perf_counter() - t0, len(steps)

    out0, first, _ = run()
    out, dt, n_steps = run()
    if [r.out for r in out] != [r.out for r in out0]:
        raise AssertionError(f"[{label}] a second run on one DecodeEngine "
                             "gave other tokens than its first (R7)")
    if sum(len(r.out) for r in out) != len(raw) * new_tokens or not all(
        r.done and all(0 <= t < cfg.vocab_size for t in r.out) for r in out
    ):
        raise AssertionError(f"[{label}] DecodeEngine did not answer every "
                             "request")
    return eng, out, dt, n_steps, first


def phase_moe_decode(device, cfg, state, weight_bytes: int):
    """[moe] (c) the MLA cache against the forward, on the forward's expert
    choices (:func:`_decode_vs_forward`), and (d) DecodeEngine."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    raw = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (DECODE_PROMPTS, DECODE_PROMPT_LEN))
    _hold_decode("moe", *_decode_vs_forward(
        "moe", cfg, state, torch.as_tensor(raw, device=device), device))

    ops.reset_launch_counts()
    eng, out, dt, n_steps, first = _answer_requests(
        "moe", cfg, state, device, raw, DECODE_NEW, DECODE_CACHE)
    total = sum(len(r.out) for r in out)
    per_step = dt * 1e3 / n_steps
    # One step reads every weight once (the embedding: 4 rows) and the
    # latent cache; its operations are those of 4 tokens.
    cache_bytes = (cfg.num_layers * DECODE_PROMPTS * DECODE_CACHE
                   * (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * 2)
    moved = weight_bytes + cache_bytes + DECODE_PROMPTS * cfg.d_model * 2
    work = sum(_moe_work(cfg, DECODE_PROMPTS, 1,
                         (DECODE_PROMPT_LEN + DECODE_NEW) / 2).values())
    bound, by = _bound(work, moved, torch.bfloat16)
    print(f"[moe] DecodeEngine: {DECODE_PROMPTS} requests x {DECODE_NEW} new"
          f" tokens (prompt {DECODE_PROMPT_LEN}, cache {DECODE_CACHE}): "
          f"{total} tokens in {dt:.3f}s, {total / dt:.1f} tok/s (first run "
          f"{first:.3f}s, the same tokens); {n_steps} steps, {per_step:.2f} "
          f"ms per step against a bound of {bound:.2f} ms by {by} "
          f"({moved / 1e9:.2f} GB, {work / 1e9:.1f} GFLOP), "
          f"{per_step / bound:.2f}x; launches {ops.launch_counts()}")
    print(f"[moe] req0: {[int(t) for t in out[0].prompt]} -> {out[0].out}")
    last = torch.as_tensor([[r.out[-1]] for r in out], device=device)
    with torch.no_grad():
        phase_trace("DeepSeek decode step", lambda: eng.model.decode_step(
            state, eng.cache, last, DECODE_PROMPT_LEN + DECODE_NEW - 1))


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


# [encdec]: SeamlessM4T-v2-large whole; [vlm]: InternVL2-76B at full width,
# cut to VLM_LAYERS of its 80 layers.  Each prefill is PREFILL_BATCH x
# PREFILL_SEQ positions (InternVL2's: 256 patches and 256 text tokens);
# then DecodeEngine answers DECODE_PROMPTS requests.
ENCDEC_ARCH, VLM_ARCH, VLM_LAYERS = ("seamless-m4t-large-v2",
                                     "internvl2-76b", 8)
DECODE_PROMPTS, DECODE_PROMPT_LEN, DECODE_NEW, DECODE_CACHE = 4, 8, 16, 128


def _hold_path_kernels(label, device, *, k1=None, k2=None, k3=None):
    """Each kernel of a path against its plain version at the shapes the
    path gives it, before the path's counted run: K1's step GEMM (rows, K)
    @ a column shard of (K, N) on GROUP ranks and K3's chunk (m_c, K) of
    each rank (the composer's), or K2's fold of a (M, K/g) panel into the
    fp32 (M, N/g) accumulator (the 2D schedule's)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_gemm import (
        accumulate_matmul,
        accumulate_route,
        chunked_matmul,
        route,
    )
    from repro_torch.kernels.dma_exchange import a2a_chunk_exchange
    from repro_torch.parallel.sharding import TPGroup, shard_columns

    randn = _randn_fn(device, 11)
    bf16, held = torch.bfloat16, []
    if k1:
        rows, k, n = k1
        x = randn(GROUP, rows, k, dtype=bf16)
        w = shard_columns(randn(k, n, dtype=bf16, scale=k ** -0.5), GROUP)
        got = chunked_matmul(x, w, block_m=rows, block_n=n // GROUP,
                             block_k=k)
        want = ref.matmul_ref(x, w)
        _sync()
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
        held.append(f"K1 {GROUP}x{rows}x{k}x{n // GROUP} bf16 on "
                    f"{route(x, w)}: max_abs_err {_max_err(got, want):.3e} "
                    "(rtol = atol = 2e-2)")
    if k3:
        m_c, k = k3
        x = randn(GROUP, GROUP * m_c, k, dtype=bf16)
        chunks = x.reshape(GROUP, GROUP, m_c, k)[:, 1]
        buf = torch.full((GROUP, GROUP, m_c, k), float("nan"), dtype=bf16,
                         device=device)
        got = a2a_chunk_exchange(
            chunks, out=buf, streams=TPGroup(GROUP, device).copy_streams[1:])
        _sync()
        if not torch.equal(got, ref.a2a_chunk_exchange_ref(chunks)):
            raise AssertionError(f"[{label}] K3 at {GROUP}x{m_c}x{k} is not "
                                 "bit-equal to its plain version")
        held.append(f"K3 {GROUP}x{m_c}x{k} bf16 on strided: bit-equal")
    if k2:
        m, k, n = k2
        k_c = k // GROUP
        c = randn(GROUP, m, n // GROUP, dtype=torch.float32)
        panel = randn(GROUP, m, k_c, dtype=bf16)
        w = shard_columns(randn(k, n, dtype=bf16, scale=k ** -0.5),
                          GROUP)[:, :k_c]
        want = ref.accumulate_matmul_ref(c.clone(), panel, w)
        got = accumulate_matmul(c, panel, w)
        _sync()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        held.append(f"K2 {GROUP}x{m}x{k_c}x{n // GROUP}, C f32, bf16 "
                    f"operands, on {accumulate_route(c, panel, w)}: "
                    f"max_abs_err {_max_err(got, want):.3e} (rtol = atol = "
                    "1e-4)")
    print(f"[{label}] the path's kernels against their plain versions at "
          "its shapes: " + "; ".join(held))


# [hybrid]: Jamba-1.5-Large at full width, cut to HYBRID_LAYERS layers with
# attention every HYBRID_ATTN_EVERY at HYBRID_ATTN_OFFSET, so one period
# holds each of Jamba's layer kinds (one 8-layer period is 90.5 GB); [ssm]:
# xLSTM-1.3B whole.  SSM_DMA_SEQ: the short prompt xLSTM runs under the
# DMA overlap context.  A prefill slower than LONG_PREFILL_S (xLSTM's
# eager time loops, ~10^6 launches) is timed once and profiled over its
# first TRACE_SEQ positions: the profiler's events take ~20 us each to
# read, and each position issues the same launches.
HYBRID_ARCH, SSM_ARCH = "jamba-1.5-large-398b", "xlstm-1.3b"
HYBRID_LAYERS, HYBRID_ATTN_EVERY, HYBRID_ATTN_OFFSET = 4, 4, 2
SSM_DMA_SEQ = 16
LONG_PREFILL_S, TRACE_SEQ = 2.0, 32


def _first_layers(n: int):
    return lambda cfg: dataclasses.replace(cfg, num_layers=n)


def _hybrid_cut(cfg):
    return dataclasses.replace(
        cfg, num_layers=HYBRID_LAYERS, hybrid=dataclasses.replace(
            cfg.hybrid, attn_every=HYBRID_ATTN_EVERY,
            attn_offset=HYBRID_ATTN_OFFSET))


def _ssm_short_cut(cfg):
    """xLSTM at full width cut to one mLSTM and one sLSTM layer."""
    return dataclasses.replace(cfg, num_layers=2, xlstm=dataclasses.replace(
        cfg.xlstm, slstm_every=2, slstm_offset=1))


def _recurrent_bytes(pattern, cache) -> int:
    """Bytes of the recurrent layers' decode state in ``cache``, whose
    slots follow ``pattern``."""
    from repro_torch.models.model import RECURRENT

    return sum(_nbytes(*c.values()) for spec, c in zip(pattern, cache)
               if spec.mixer in RECURRENT)


def _hold_decode(label, err, scale):
    if err > 5e-2 * scale:
        raise AssertionError(f"[{label}] decode logits differ from the "
                             f"forward by {err} (> 5% of {scale})")


def _decode_vs_forward(label, cfg, state, toks, device, frames=None):
    """The cached decode over ``toks`` step by step against the forward
    over them (an encoder-decoder's over ``frames`` too, its cross K/V
    from ``prefill_cross``); prints both and returns (max abs error, max
    |logit|).  An MoE model runs both at capacity factor E / k, where
    nothing is dropped, and the decode takes the forward's expert choices
    (:class:`_Routing`): a step's GEMMs round differently from the
    forward's and near-tied choices flip, so the free-running decode and
    the share of choices that differ are printed beside it.  Raises on a
    logit that is not finite."""
    import torch

    from repro_torch.configs.base import OverlapConfig
    from repro_torch.models.model import build_model
    from repro_torch.tree import leaves

    check_cfg = dataclasses.replace(cfg, overlap=OverlapConfig())
    if cfg.moe:
        check_cfg = dataclasses.replace(check_cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = build_model(check_cfg)
    prompts, prompt_len = toks.shape
    enc_len = 0 if frames is None else frames.shape[1]

    def decode():
        cache = model.init_cache(prompts, DECODE_CACHE, enc_len=enc_len,
                                 device=device)
        if enc_len:
            cache = model.prefill_cross(state, cache, frames)
        steps = []
        for pos in range(prompt_len):
            lg, cache = model.decode_step(state, cache, toks[:, pos:pos + 1],
                                          pos)
            steps.append(lg)
        return torch.cat(steps, dim=1), cache

    batch = {"tokens": toks}
    if enc_len:
        batch["enc_frames"] = frames
    with torch.no_grad(), _Routing() as routing:
        full, _ = model.forward(state, batch)
        # The forward's choices for token (b, p) in MoE layer l, in the
        # order the decode steps ask for them: step p, layer l, rows b.
        fwd = [c.view(prompts, prompt_len, -1) for c in routing.take()]
        free, cache = decode()
        decoded, free_err = free, ""
        if fwd:
            calls, k = routing.take(), cfg.moe.top_k
            flipped = statistics.mean(
                _choices_differ(f.reshape(-1, k),
                                torch.stack(calls[i::len(fwd)], 1)
                                .reshape(-1, k), cfg.moe.num_experts)
                for i, f in enumerate(fwd))
            free_err = (f"; free-running, on its own expert choices: "
                        f"max_abs_err {_max_err(free, full):.4e}, expert "
                        f"choices that differ {flipped:.2e}")
            routing.replay = iter([f[:, p] for p in range(prompt_len)
                                   for f in fwd])
            decoded, cache = decode()
            routing.replay = None
    if not torch.isfinite(decoded).all():
        raise AssertionError(f"[{label}] decode logits not finite")
    scale = full.float().abs().max().item()
    err = _max_err(decoded, full)
    cross = f", cross K/V of {enc_len} frames" if enc_len else ""
    print(f"[{label}] cached decode vs forward over {prompts}x{prompt_len} "
          f"prompt tokens, {cfg.num_layers} layers in {cfg.dtype}{cross} "
          f"(cache {_nbytes(*leaves(cache)) / 2 ** 20:.1f} MiB, recurrent "
          f"state {_recurrent_bytes(model.pattern, cache) / 2 ** 20:.1f} "
          f"MiB): max_abs_err {err:.4e} (max |logit| {scale:.4f}, ratio "
          f"{err / scale:.3e}){free_err}")
    return err, scale


def _hold_ssm_decode(label, cfg, model, state, toks, device):
    """xLSTM's random bf16 model amplifies a rounding through its 48
    layers: on an H100 two bf16 forwards of one prompt whose GEMMs take
    other shapes differ by half the largest logit, as do its decode and
    forward (PERF.md §6).  Its decode is held instead (a) at full depth in
    fp32, on a copy of the weights, and (b) in bf16 on a cut of one mLSTM
    and one sLSTM layer at full width (seed 0), where the rounding has no
    depth to grow in.  Beside them the bf16 forward against itself at
    another length."""
    import torch

    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_map

    with torch.no_grad():
        longer = torch.cat([toks, toks], dim=1)
        short, _ = model.forward(state, {"tokens": toks})
        long_lg, _ = model.forward(state, {"tokens": longer})
    drift = _max_err(short, long_lg[:, :toks.shape[1]])
    print(f"[{label}] in {cfg.dtype}, the forward over {tuple(toks.shape)} "
          f"against its own first {toks.shape[1]} positions over "
          f"{tuple(longer.shape)}: max_abs_err {drift:.4e} (ratio "
          f"{drift / short.float().abs().max().item():.3e}); held in fp32 "
          "and on a short cut:")
    del short, long_lg
    wide = tree_map(lambda t: t.float(), state)
    _hold_decode(label, *_decode_vs_forward(
        label, dataclasses.replace(cfg, dtype="float32"), wide, toks,
        device))
    del wide
    cut = _ssm_short_cut(cfg)
    _hold_decode(label, *_decode_vs_forward(
        label, cut, build_model(cut).init(0, device=device), toks, device))


def phase_model(device, label, arch, cut=None):
    """[encdec] / [vlm] / [hybrid] / [ssm]: a model of the registry at full
    width (``cut`` to fewer layers where the card needs it), random from
    seed 0.  (a) Its parameters against the port's counters, bytes, peak
    memory; (b) a 4 x 512 prefill dense and on the DMA path (K1 + K3 in
    every MLP, an encoder's too) through ``make_prefill``, the launches
    asserted and the logits within 5 % of dense, or, for a model with no
    FiCCO site (xLSTM), a short prompt under the DMA context that launches
    nothing and equals dense bit for bit; (c) walls and one profiled run
    per path beside the counters' prefill bound; (d) the cached decode
    against the forward within 5 % (xLSTM: :func:`_hold_ssm_decode`); (e)
    ``DecodeEngine`` per step beside its byte bound, two runs of one
    engine giving the same tokens (ROADMAP R7).  Returns each kernel's
    launches in one prefill of the main path."""
    import gc

    import numpy as np
    import torch

    from repro_torch import roofline
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Family, OverlapConfig, ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import TPGroup, tp_group
    from repro_torch.serve.engine import make_prefill
    from repro_torch.tree import leaves
    from repro_torch.tune.registry import resolve_variant

    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(arch)
    cfg = dataclasses.replace(
        cut(full) if cut else full,
        overlap=OverlapConfig(mode="ficco_auto", backend="dma"))
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state = model.init(0, device=device)
    _sync()
    t_init = time.time() - t0
    n_params = sum(t.numel() for t in leaves(state))
    n_bytes = _nbytes(*leaves(state))
    fp32 = _nbytes(*(t for t in leaves(state) if t.dtype == torch.float32))
    counted = roofline.count_params(cfg)
    if counted != n_params:
        raise AssertionError(f"[{label}] {n_params} parameters on the card, "
                             f"{counted} by roofline.count_params")
    kinds = ", ".join(f"({s.mixer}, {s.ffn})" for s in model.pattern)
    what = (f"cut to {cfg.num_layers} of its {full.num_layers} layers"
            if cfg.num_layers != full.num_layers else "whole")
    enc = (f", encoder {cfg.encdec.encoder_layers} layers"
           if cfg.encdec else "")
    front = (f", {cfg.frontend.prefix_tokens} prefix patches through the "
             f"{cfg.frontend.embed_dim} -> {cfg.d_model} projector"
             if cfg.frontend and cfg.frontend.embed_dim else "")
    print(f"[{label}] {cfg.name} ({what}; whole: "
          f"{roofline.count_params(full) / 1e9:.3f}e9 parameters): "
          f"{cfg.num_layers} layers of period [{kinds}]{enc}, d "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}{front}; "
          f"{n_params / 1e9:.3f}e9 parameters (roofline.count_params: "
          f"{counted / 1e9:.3f}e9), {n_bytes / 1e9:.2f} GB {cfg.dtype} of "
          f"which {fp32 / 1e9:.2f} GB fp32 leaves, random (seed 0) in "
          f"{t_init:.1f}s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    shape = ShapeConfig("smoke", PREFILL_SEQ, PREFILL_BATCH, "prefill")
    # The tokens, and the stub frontends' frames and patches.
    batch = to_device(SyntheticLM(cfg, shape, seed=0).batch_at(0), device)
    print(f"[{label}] batch (seed 0): "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items()))
    want_shape = (PREFILL_BATCH, batch["tokens"].shape[1], cfg.vocab_size)
    prefill = make_prefill(model)
    group = TPGroup(GROUP, device)

    def in_group(b=batch):
        with tp_group(group):
            return prefill(state, b)

    # (b) Every MLP, an encoder's too, is a FiCCO site.
    n_mlp = (sum(s.ffn == "mlp" for s in model.pattern) * model.n_periods
             + (cfg.encdec.encoder_layers if cfg.encdec else 0))
    n_local = cfg.d_ff // GROUP
    expected = _dma_launches(resolve_variant("dma_exchange", group=GROUP),
                             2 * n_mlp, n_local)
    if n_mlp:
        rows = PREFILL_BATCH * PREFILL_SEQ // GROUP  # g * m_c
        _hold_path_kernels(label, device, k1=(rows, cfg.d_model, cfg.d_ff),
                           k3=(rows // GROUP, cfg.d_model))
        check = batch
    else:  # no FiCCO site: a short prompt shows the context changes nothing
        check = {"tokens": batch["tokens"][:, :SSM_DMA_SEQ]}
    with torch.no_grad():
        dense = prefill(state, check)
        ops.reset_launch_counts()
        dma = in_group(check)
        _sync()
    counts, routes = _check_launches(label, "DMA-path prefill", expected)
    print(f"[{label}] DMA-path prefill {tuple(check['tokens'].shape)}: "
          f"launches {counts} by route {routes} (expected {expected}: "
          f"{n_mlp} MLPs x 2 projections x {GROUP} steps, n_local "
          f"{n_local}, K {cfg.d_model}; no other mixer or FFN holds a FiCCO "
          "site)")
    for name, lg in (("dense", dense), ("DMA path", dma)):
        if not torch.isfinite(lg).all() or lg.shape[-1] != cfg.vocab_size:
            raise AssertionError(f"[{label}] {name} logits "
                                 f"{tuple(lg.shape)} not finite")
    scale = dense.float().abs().max().item()
    err = _max_err(dma, dense)
    agree = (dma.argmax(-1) == dense.argmax(-1)).float().mean().item()
    print(f"[{label}] DMA-path logits vs dense: max_abs_err {err:.4e} (max "
          f"|logit| {scale:.4f}, ratio {err / scale:.3e}), argmax agreement "
          f"{agree:.4f}")
    if n_mlp and err > 5e-2 * scale:
        raise AssertionError(f"[{label}] DMA-path logits differ from dense "
                             f"by {err} (> 5% of {scale})")
    if not n_mlp and not torch.equal(dma, dense):
        raise AssertionError(f"[{label}] logits under the DMA context are "
                             "not bit-equal to dense")
    del dense, dma

    # (c) Walls: two turns of 3 on each path, or the one run of a prefill
    # that takes seconds; one profiled run each.
    paths = [("dense", lambda b=batch: prefill(state, b))]
    if n_mlp:
        paths.insert(0, ("DMA path", in_group))
    n_tok = PREFILL_BATCH * PREFILL_SEQ
    walls, traces = {}, {}

    def report(name, ms):
        walls.setdefault(name, []).append(ms)
        print(f"[{label}] prefill {PREFILL_BATCH}x{PREFILL_SEQ}, {name}: "
              f"{ms:.2f} ms wall ({n_tok / ms * 1e3:.0f} positions/s)")

    with torch.no_grad():
        _sync()
        t0 = time.perf_counter()
        lg = prefill(state, batch)
        _sync()
        first = time.perf_counter() - t0
        if tuple(lg.shape) != want_shape or not torch.isfinite(lg).all():
            raise AssertionError(f"[{label}] prefill logits "
                                 f"{tuple(lg.shape)} not finite or not "
                                 f"{want_shape}")
        del lg
        traced = batch
        if first < LONG_PREFILL_S:
            for name, fn in paths * 2:
                report(name, wall_ms(fn, reps=3))
        else:
            report("dense", first * 1e3)
            traced = {k: v[:, :TRACE_SEQ] for k, v in batch.items()}
        for name, fn in paths:
            traces[name] = phase_trace(
                f"{cfg.name} {name} prefill "
                f"{tuple(traced['tokens'].shape)}", lambda: fn(traced))
    costs = roofline.step_costs(cfg, shape, "prefill")
    bound, by = _bound(costs.flops, costs.bytes, torch.bfloat16)
    print(f"[{label}] prefill bound {bound:.2f} ms by {by} (counters' "
          f"step_costs: {costs.flops / 1e12:.2f} TFLOP, "
          f"{costs.bytes / 1e9:.2f} GB); "
          + "; ".join(f"{name}: best wall {min(walls[name]):.2f} ms = "
                      f"{min(walls[name]) / bound:.2f}x the bound, device "
                      f"busy {traces[name]['busy_ms']:.2f} ms and idle "
                      f"share {traces[name]['idle']:.3f} over the profiled "
                      f"{tuple(traced['tokens'].shape)} prefill"
                      for name, _ in paths)
          + f"; on {_card()}")

    # (d) The cached decode against the forward over the same tokens (and
    # frames).
    raw = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (DECODE_PROMPTS, DECODE_PROMPT_LEN))
    toks = torch.as_tensor(raw, device=device)
    frames = batch["enc_frames"][:DECODE_PROMPTS] if cfg.encdec else None
    err, scale = _decode_vs_forward(label, cfg, state, toks, device, frames)
    if cfg.family is Family.SSM:
        _hold_ssm_decode(label, cfg, model, state, toks, device)
    else:
        _hold_decode(label, err, scale)

    # (e) One engine answers the same requests twice; the second run is
    # timed and must repeat the first's tokens.
    s_enc = 0 if frames is None else frames.shape[1]
    eng, out, dt, n_steps, first = _answer_requests(
        label, cfg, state, device, raw, DECODE_NEW, DECODE_CACHE,
        enc_len=s_enc, frames=frames)
    total = sum(len(r.out) for r in out)
    per_step = dt * 1e3 / n_steps
    # A step reads the decoder's weights once (the embedding: 4 rows), its
    # caches as they lie, and reads and writes the recurrent state.
    dec_bytes = (_nbytes(*leaves(state["layers"]), *leaves(
        state["final_norm"])) + _nbytes(state.get("unembed", state["embed"])))
    moved = (dec_bytes + _nbytes(*leaves(eng.cache))
             + _recurrent_bytes(model.pattern, eng.cache)
             + DECODE_PROMPTS * cfg.d_model * 2)
    flops = roofline.forward_costs(
        cfg, DECODE_PROMPTS, 1, ctx=DECODE_PROMPT_LEN + DECODE_NEW,
        decode=True).flops
    bound, by = _bound(flops, moved, torch.bfloat16)
    print(f"[{label}] DecodeEngine: {DECODE_PROMPTS} requests x {DECODE_NEW}"
          f" new tokens (prompt {DECODE_PROMPT_LEN}, cache {DECODE_CACHE}"
          f"{f', enc_len {s_enc}' if s_enc else ''}): {total} tokens in "
          f"{dt:.3f}s, {total / dt:.1f} tok/s (first run {first:.3f}s, the "
          f"same tokens: R7 holds); {n_steps} steps, {per_step:.2f} ms per "
          f"step against a bound of {bound:.3f} ms by {by} "
          f"({moved / 1e9:.3f} GB; counters' param_bytes "
          f"{roofline.param_bytes(cfg) / 1e9:.3f} GB at 2 bytes each), "
          f"{per_step / bound:.1f}x; on {_card()}")
    print(f"[{label}] req0: {[int(t) for t in out[0].prompt]} -> {out[0].out}")
    del eng, state, batch
    print(f"[{label}] phase total {time.time() - t_phase:.1f}s")
    return counts


# [moe-train]: DeepSeek-V2-Lite-16B at full width, cut to MOE_TRAIN_LAYERS
# of its 27 layers, at TRAIN_BATCH x TRAIN_SEQ tokens.  [hybrid-train]:
# Jamba-1.5-Large at full width cut to HYBRID_TRAIN_LAYERS layers,
# attention every second layer at offset 1 and the MoE every fourth, so the
# cut is [(Mamba, MLP), (attention, MLP)]: one of Jamba's MoE layers alone
# is 16 x 3 x 8192 x 24576 = 9.66e9 parameters, more than 110 GB of AdamW
# state, so no full-width cut that holds one trains on one card
# ([moe-train] holds the MoE backward).  [ssm-train]: xLSTM-1.3B at full
# width cut to its first period, SSM_TRAIN_LAYERS layers (7 mLSTM, 1
# sLSTM), at SSM_TRAIN_BATCH x SSM_TRAIN_SEQ tokens: eager autograd keeps
# two (B, H, hd, hd) fp32 tensors per mLSTM step (16 MB a batch row at hd
# 1024), as the reference's lax.scan does.  One warm-up step and
# MODEL_TRAIN_STEPS timed steps per path, one path's state at a time.
# SITE_GRAD_LIMIT: the 2D path's FiCCO-site gradients against dense's, the
# largest |2D - dense| / |dense| (norms over one leaf of one period), about
# twice what an H100 gave (1.98e-2 for DeepSeek, 7.55e-3 for Jamba).
MOE_TRAIN_LAYERS, HYBRID_TRAIN_LAYERS = 2, 2
SSM_TRAIN_LAYERS, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 8, 2, 64
MODEL_TRAIN_STEPS = 3
SITE_GRAD_LIMIT = {"deepseek-v2-lite-16b": 4e-2,
                   "jamba-1.5-large-398b": 1.5e-2}


def _hybrid_train_cut(cfg):
    return dataclasses.replace(
        cfg, num_layers=HYBRID_TRAIN_LAYERS,
        hybrid=dataclasses.replace(cfg.hybrid, attn_every=2, attn_offset=1),
        moe=dataclasses.replace(cfg.moe, every_k_layers=4))


def _scan_residuals(cfg, pattern, n_periods, batch, seq) -> tuple:
    """(bytes, how): what eager autograd keeps for the recurrent scans'
    backward.  A Mamba step saves exp(dt A) and the state it multiplies,
    (B, D_inner, N) fp32 each; an mLSTM step the state it decays and the
    fp32 outer product k v^T, (B, H, hd, hd) each; an sLSTM step a few
    (B, D_inner) vectors (counted as 8)."""
    from repro_torch.models.mamba import mamba_dims

    per_step, how = 0, []
    for spec in pattern:
        if spec.mixer == "mamba":
            d_inner, _ = mamba_dims(cfg.d_model, cfg.hybrid.mamba)
            b = 2 * batch * d_inner * cfg.hybrid.mamba.d_state * 4
            how.append(f"Mamba 2 x {batch}x{d_inner}x"
                       f"{cfg.hybrid.mamba.d_state} fp32")
        elif spec.mixer == "mlstm":
            hd = int(cfg.xlstm.proj_factor * cfg.d_model) // cfg.num_heads
            b = 2 * batch * cfg.num_heads * hd * hd * 4
            how.append(f"mLSTM 2 x {batch}x{cfg.num_heads}x{hd}x{hd} fp32")
        elif spec.mixer == "slstm":
            b = 8 * batch * int(cfg.xlstm.proj_factor * cfg.d_model) * 4
            how.append("sLSTM 8 vectors")
        else:
            continue
        per_step += b * n_periods
    return per_step * seq, ", ".join(sorted(set(how)))


def _ficco_sites(cfg, pattern) -> dict:
    """{prefix of the leaves: K2's N} for each layer of the period whose
    FFN the 2D schedule runs: an MLP, or an MoE layer's shared experts."""
    e = cfg.moe
    sites = {}
    for i, spec in enumerate(pattern):
        if spec.ffn == "mlp":
            sites[f"layers/{i}/ffn/"] = cfg.d_ff
        elif spec.ffn == "moe" and e.num_shared_experts:
            sites[f"layers/{i}/ffn/shared/"] = (e.d_ff_expert
                                                * e.num_shared_experts)
    return sites


def phase_model_train(device, label, arch, cut, batch_n, seq):
    """[moe-train] / [hybrid-train] / [ssm-train]: train steps of a model
    at full width, cut to a few layers, random from seed 0, on
    ``SyntheticLM`` batches: on uniform-fused-2d over GROUP ranks where it
    has a FiCCO site (K2 folds each step of the schedule), and dense.
    (a) Two equal gradient computations per path without remat bit for
    bit, every layer's leaf finite and nonzero in each period, each
    gradient in its parameter's dtype, K2's launches; the 2D path's
    FiCCO-site leaves against dense's per period; the DMA backend refuses
    to be differentiated; (b) steps with the config's remat, each path's
    state alone on the card: K2's launches and the collectives counted per
    step, the step-1 loss (1 %) and gradient norm (5 %) against dense;
    (c) the wall per step beside ``roofline.analyze``'s three terms, peak
    memory beside the prediction, one profiled step.  Returns each
    kernel's launches in the last timed step of the first path."""
    import gc

    import torch

    from repro_torch import roofline
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OverlapConfig, ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.parallel.collectives import counting
    from repro_torch.parallel.sharding import TPGroup, tp_group
    from repro_torch.train.loop import loss_and_grads, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_state
    from repro_torch.tree import leaves, named_leaves

    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(arch)
    cfg = cut(full)
    dense = build_model(cfg)
    sites = _ficco_sites(cfg, dense.pattern)
    n_sites = len(sites) * dense.n_periods
    group = TPGroup(GROUP, device)
    paths = {}
    if sites:
        paths["2D path"] = (dataclasses.replace(cfg, overlap=OverlapConfig(
            mode="uniform-fused-2d", backend="collective")), group)
    paths["dense"] = (cfg, None)
    torch.cuda.reset_peak_memory_stats(device)
    params = dense.init(0, device=device)
    n_params = sum(t.numel() for t in leaves(params))
    p_bytes = _nbytes(*leaves(params))
    fp32 = [n for n, t in named_leaves(params) if t.dtype == torch.float32]
    counted = roofline.count_params(cfg)
    if counted != n_params:
        raise AssertionError(f"[{label}] {n_params} parameters on the card, "
                             f"{counted} by roofline.count_params")
    kinds = ", ".join(f"({s.mixer}, {s.ffn})" for s in dense.pattern)
    shape = ShapeConfig("smoke", seq, batch_n, "train")
    print(f"[{label}] {cfg.name} at full width (d {cfg.d_model}, "
          f"{cfg.num_heads} / {cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}; whole: {full.num_layers} layers, "
          f"{roofline.count_params(full) / 1e9:.3f}e9 parameters), cut to "
          f"{cfg.num_layers} layers of period [{kinds}]: {n_params / 1e9:.3f}"
          f"e9 parameters (roofline.count_params: {counted / 1e9:.3f}e9), "
          f"{p_bytes / 1e9:.2f} GB {cfg.dtype} with fp32 leaves "
          + (", ".join(sorted({n.rsplit('/', 1)[-1] for n in fp32}))
             or "none")
          + f"; remat {cfg.remat} (policy {cfg.remat_policy!r}); "
          f"{batch_n}x{seq} SyntheticLM tokens (seed 0), AdamW with fp32 "
          f"moments; paths: {', '.join(paths)}")
    if full.moe and not cfg.moe.every_k_layers <= cfg.num_layers:
        e = full.moe
        print(f"[{label}] the cut holds no MoE layer: one is {e.num_experts}"
              f" x 3 x {full.d_model} x {e.d_ff_expert} = "
              f"{e.num_experts * 3 * full.d_model * e.d_ff_expert / 1e9:.2f}"
              "e9 parameters, more than 110 GB with its AdamW state")
    # The prediction: the step holds the parameters, the moments, the
    # gradients and the scans' residuals; the update (out of place) holds
    # the old and new parameters and moments with the gradients, and four
    # fp32 temporaries of the largest leaf.  Each path starts
    # from weights drawn anew from the seed: no path keeps another's.
    moments = 2 * 4 * n_params
    resid, how = _scan_residuals(cfg, dense.pattern, dense.n_periods,
                                 batch_n, seq)
    logits = batch_n * seq * cfg.vocab_size * (2 + 4 + 4)
    temps = 4 * 4 * max(t.numel() for t in leaves(params))
    backward = p_bytes + moments + p_bytes + resid + logits
    update = 2 * (p_bytes + moments) + p_bytes + temps
    predicted = max(backward, update)
    print(f"[{label}] predicted peak memory {predicted / 1e9:.2f} GB: the "
          f"backward {backward / 1e9:.2f} GB (parameters "
          f"{p_bytes / 1e9:.2f} GB, moments {moments / 1e9:.2f}, gradients "
          f"{p_bytes / 1e9:.2f}, the scans' residuals {resid / 1e9:.2f}"
          + (f" ({how} a step, {seq} steps)" if resid else "")
          + f", logits {logits / 1e9:.2f}), the update {update / 1e9:.2f} "
          f"GB (old and new state, gradients, temporaries "
          f"{temps / 1e9:.2f})")
    sums = [float(t.float().sum()) for t in leaves(params)]
    data = SyntheticLM(cfg, shape, seed=0)
    batches = [to_device(data.batch_at(i), device)
               for i in range(1 + MODEL_TRAIN_STEPS)]
    site_launches = ({"accumulate_matmul": n_sites * 2 * GROUP} if sites
                     else {})
    if sites:
        _hold_path_kernels(label, device, k2=(
            batch_n * seq, cfg.d_model, next(iter(sites.values()))))
    failures = []

    # (a) Two equal gradient computations per path without remat, bit for
    # bit; K2 folds each projection of each FiCCO site once a computation.
    layer_leaves = [n for n, _ in named_leaves(params)
                    if n.startswith("layers/")]
    parts = {}  # "attn", "mixer", "ffn", "norm1", ...: their leaves' names
    for n in layer_leaves:
        part, leaf = n.split("/", 3)[2:]
        parts.setdefault(part, set()).add(leaf)
    site_leaves = [n for n in layer_leaves if n.startswith(tuple(sites))]
    site_grads = {}
    for name, (pcfg, grp) in paths.items():
        model = build_model(dataclasses.replace(pcfg, remat=False))
        runs = []
        for _ in range(2):
            ops.reset_launch_counts()
            with tp_group(grp):
                loss, _, g = loss_and_grads(model, params, batches[0])
            _sync()
            _check_launches(label, f"{name} gradient computation",
                            site_launches if grp else {})
            runs.append(dict(named_leaves(g)))
        differ = [n for n in runs[0]
                  if not torch.equal(runs[0][n], runs[1][n])]
        if differ:
            failures.append(f"{name}: gradients differ run to run: {differ}")
        for n, p in named_leaves(params):
            g = runs[0][n]
            if g.dtype != p.dtype:
                failures.append(f"{name} {n}: gradient {g.dtype}, parameter "
                                f"{p.dtype}")
        for n in layer_leaves:
            t = runs[0][n]
            for i in range(dense.n_periods):
                if not torch.isfinite(t[i]).all() or not t[i].abs().max():
                    failures.append(f"{name} {n} period {i}: not finite or "
                                    "zero")
        norm = math.sqrt(sum(float(t.float().square().sum())
                             for t in runs[0].values()))
        print(f"[{label}] {name}, remat off: two equal gradient computations"
              f", {len(runs[0]) - len(differ)} of {len(runs[0])} leaves "
              f"bit-equal; loss {loss.item():.6f}, gradient norm "
              f"{norm:.6f}; all {len(layer_leaves)} layer leaves ("
              + "; ".join(f"{part}: {', '.join(sorted(names))}"
                          for part, names in sorted(parts.items()))
              + f") finite and nonzero in every period, each gradient in its"
              f" parameter's dtype (fp32: {len(fp32)} leaves); launches "
              f"{dict(ops.launch_counts())}")
        site_grads[name] = {n: runs[0][n] for n in site_leaves}
        del runs, g
    if sites:
        worst, where = 0.0, None
        for n in site_leaves:
            for i in range(dense.n_periods):
                want = site_grads["dense"][n][i].float()
                got = site_grads["2D path"][n][i].float()
                gap = float((got - want).norm() / want.norm())
                if gap > worst:
                    worst, where = gap, f"{n} period {i}"
        print(f"[{label}] the 2D path's {len(site_leaves)} FiCCO-site leaves"
              f" against dense's, per period: worst |2D - dense| / |dense| "
              f"{worst:.3e} ({where}; limit {SITE_GRAD_LIMIT[arch]})")
        if not worst <= SITE_GRAD_LIMIT[arch]:
            failures.append(f"the 2D path's {where} gradient is "
                            f"{worst:.3e} off dense's")
        try:
            with tp_group(group):
                loss_and_grads(build_model(dataclasses.replace(
                    cfg, remat=False, overlap=OverlapConfig(
                        mode="uniform-fused-1d", backend="dma"))),
                    params, batches[0])
        except RuntimeError as err:
            if "reverse-mode" not in str(err):
                raise
            print(f"[{label}] DMA backend under grad raises: {err}")
        else:
            failures.append("the DMA backend did not refuse to be "
                            "differentiated")
    del site_grads

    # (b) Train steps with the config's remat, one path's state at a time.
    ocfg = OptimizerConfig(warmup_steps=2)
    tokens_n = batch_n * seq
    walls, metrics, colls, peaks, first_counts = {}, {}, {}, {}, None
    costs = roofline.step_costs(cfg, shape, "train")
    flops6 = roofline.model_flops_for(cfg, shape, "train")
    for i_path, (name, (pcfg, grp)) in enumerate(paths.items()):
        if i_path:  # the same weights, drawn anew from the seed
            params = dense.init(0, device=device)
            if [float(t.float().sum()) for t in leaves(params)] != sums:
                raise AssertionError(f"[{label}] seed 0 drew other weights "
                                     "the second time")
        step = make_train_step(build_model(pcfg), ocfg)
        state = {"params": params, "opt_state": init_state(params)}
        del params
        expected = ({"accumulate_matmul": n_sites * 2 * GROUP
                     * (2 if pcfg.remat else 1)} if grp else {})
        walls[name], metrics[name] = [], []
        for i, batch in enumerate(batches):
            _sync()
            if i == len(batches) - 1:
                torch.cuda.reset_peak_memory_stats(device)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with tp_group(grp), counting() as stats:
                state, m = step(state, batch)
            _sync()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            counts, routes = _check_launches(label, f"{name} step {i + 1}",
                                             expected)
            metrics[name].append({k: float(v) for k, v in m.items()})
            if not all(map(math.isfinite, metrics[name][-1].values())):
                failures.append(f"{name} step {i + 1}: metrics "
                                f"{metrics[name][-1]}")
            colls[name] = stats
        peaks[name] = torch.cuda.max_memory_allocated(device)
        if first_counts is None:
            first_counts, first_routes = counts, routes

        if i_path == 0:  # one profiled step, on the last step's state
            with tp_group(grp):
                trace = phase_trace(f"{cfg.name} {name} train step",
                                    lambda: step(state, batches[0]))
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        want_calls = n_sites * 2 * GROUP if grp else 0
        got_calls = sum(colls[name].count_by_kind.values())
        if got_calls != want_calls:
            failures.append(f"{name}: {colls[name].count_by_kind} "
                            f"collectives counted per step, expected "
                            f"{want_calls} all-gathers")
    if len(paths) > 1:
        a, b = metrics["2D path"][0], metrics["dense"][0]
        for key, limit in (("loss", 1e-2), ("grad_norm", 5e-2)):
            diff = abs(a[key] - b[key])
            print(f"[{label}] step 1 {key}: 2D path {a[key]:.6f}, dense "
                  f"{b[key]:.6f} (relative diff {diff / abs(b[key]):.3e}, "
                  f"limit {limit})")
            if diff > limit * abs(b[key]):
                failures.append(f"step 1 {key} of the 2D path differs from "
                                "dense")
    for name in paths:
        timed = walls[name][1:]
        med = statistics.median(timed)
        r = roofline.analyze(
            arch=cfg.name, shape=f"{batch_n}x{seq}", mesh_name=(
                f"TPGroup({GROUP}) on one card" if paths[name][1]
                else "one card"), chips=1, costs=costs,
            collectives=colls[name], model_flops=flops6,
            bytes_per_device=peaks[name])
        t_max = max(r.t_compute, r.t_memory, r.t_collective) * 1e3
        print(f"[{label}] {name}: step wall median {med:.2f} ms over "
              f"{len(timed)} steps (min {min(timed):.2f}, max "
              f"{max(timed):.2f}; warm-up {walls[name][0]:.2f}), "
              f"{tokens_n / med * 1e3:.0f} tok/s; loss "
              + " -> ".join(f"{m['loss']:.4f}" for m in metrics[name])
              + f"; analyze(): t_compute {r.t_compute * 1e3:.2f} ms, "
              f"t_memory {r.t_memory * 1e3:.2f} ms, t_collective "
              f"{r.t_collective * 1e3:.3f} ms ({r.collectives} in "
              f"{r.collective_counts} calls a step, per-rank bytes; on one "
              f"card the exchange is a device copy), dominant {r.dominant}, "
              f"useful_flops_ratio {r.useful_flops_ratio:.3f}; the wall is "
              f"{med / t_max:.1f}x the largest term; peak over the last step"
              f" {r.bytes_per_device / 1e9:.2f} GB")
    print(f"[{label}] launches in the last timed {next(iter(paths))} step: "
          f"{first_counts} by route {first_routes}"
          + (f" (K2: {n_sites} FiCCO sites x 2 projections x {GROUP} steps"
             + (" x 2, the forward and its recomputation" if cfg.remat
                else "") + ")" if sites else " (no FiCCO site)")
          + f"; phase peak memory "
          f"{max(peaks.values()) / 1e9:.2f} GB against the predicted "
          f"{predicted / 1e9:.2f} GB; profiled step: device busy "
          f"{trace['busy_ms']:.2f} ms, idle share {trace['idle']:.3f}; on "
          f"{_card()}")
    if failures:
        raise AssertionError(f"[{label}] " + "; ".join(failures))
    print(f"[{label}] phase total {time.time() - t_phase:.1f}s")
    return first_counts


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
    phase_adapt(device, cfg, state)
    train_counts = phase_train(device, cfg, state)
    for k in kernels:
        k["train_step_launches"] = train_counts[k["name"]]
    phase_grid(device)
    phase_learn(device)
    phase_sweep(device)
    phase_dryrun(device)
    # [moe] needs the card's memory: TinyLlama's state goes first.
    del model, state
    moe_counts = phase_moe(device, timer)
    moe_train_counts = phase_model_train(
        device, "moe-train", MOE_ARCH, _first_layers(MOE_TRAIN_LAYERS),
        TRAIN_BATCH, TRAIN_SEQ)
    encdec_counts = phase_model(device, "encdec", ENCDEC_ARCH)
    vlm_counts = phase_model(device, "vlm", VLM_ARCH,
                             _first_layers(VLM_LAYERS))
    hybrid_counts = phase_model(device, "hybrid", HYBRID_ARCH, _hybrid_cut)
    ssm_counts = phase_model(device, "ssm", SSM_ARCH)
    hybrid_train_counts = phase_model_train(
        device, "hybrid-train", HYBRID_ARCH, _hybrid_train_cut, TRAIN_BATCH,
        TRAIN_SEQ)
    ssm_train_counts = phase_model_train(
        device, "ssm-train", SSM_ARCH, _first_layers(SSM_TRAIN_LAYERS),
        SSM_TRAIN_BATCH, SSM_TRAIN_SEQ)
    for k in kernels:
        k["moe_prefill_launches"] = moe_counts[k["name"]]
        k["moe_train_step_launches"] = moe_train_counts[k["name"]]
        k["encdec_prefill_launches"] = encdec_counts[k["name"]]
        k["vlm_prefill_launches"] = vlm_counts[k["name"]]
        k["hybrid_prefill_launches"] = hybrid_counts[k["name"]]
        k["ssm_prefill_launches"] = ssm_counts[k["name"]]
        k["hybrid_train_step_launches"] = hybrid_train_counts[k["name"]]
        k["ssm_train_step_launches"] = ssm_train_counts[k["name"]]

    print(f"[done] every phase passed ({', '.join(PHASES)}) in "
          f"{time.time() - t_start:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches", "routes",
            "train_step_launches", "moe_prefill_launches",
            "moe_train_step_launches", "encdec_prefill_launches",
            "vlm_prefill_launches", "hybrid_prefill_launches",
            "ssm_prefill_launches", "hybrid_train_step_launches",
            "ssm_train_step_launches", "max_abs_err",
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
