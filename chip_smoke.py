#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit; build the CUDA kernels (one nvcc per
     source, in parallel) and print the build time;
  2. every kernel against its plain PyTorch version on the card, at the
     reference's test shapes and at the shapes of the main path, with
     CUDA-event timings beside the plain version's and one PyTorch call's;
  3. the main path: full-width TinyLlama-1.1B prefill (4 prompts x 512
     tokens) through ``make_prefill`` with the DMA-backend uniform-fused-1D
     TP MLP on a group of 4 logical ranks, held against the dense forward,
     with the kernels' launch counts read around it;
  4. serving: ``DecodeEngine`` answers 4 requests on the same weights;
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
REPS = 20


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

    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    # K1 at the reference's tests/test_kernels.py shapes and tolerances.
    for m, n, k in [(128, 128, 128), (256, 128, 384), (384, 256, 128),
                    (128, 384, 256)]:
        for dtype, tol in [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]:
            x, w = randn(m, k, dtype=dtype), randn(k, n, dtype=dtype)
            got = chunked_matmul(x, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref.matmul_ref(x, w),
                                       rtol=tol, atol=tol)
    # bf16 at a shape the tensor-core tile does not divide (CUDA-core path).
    x, w = randn(192, 96, dtype=torch.bfloat16), randn(96, 320,
                                                     dtype=torch.bfloat16)
    got = chunked_matmul(x, w, block_m=64, block_n=64, block_k=32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.matmul_ref(x, w), rtol=2e-2,
                               atol=2e-2)
    print("[kernels] K1 chunked_matmul matches matmul_ref at the 4 "
          "test_kernels shapes, f32 (1e-4) and bf16 (2e-2), and at "
          "192x320x96 bf16 (untiled path)")

    # K1 at the main path's step GEMM: 4 ranks x (g*m_c=512, K=2048) @
    # (2048, n_local=1408), the weight a strided column-shard view.
    d_model, d_ff = 2048, 5632
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


def phase_prefill(device):
    """Full-width TinyLlama-1.1B prefill on the DMA path; launch counts."""
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
    torch.cuda.synchronize()
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
    group = TPGroup(GROUP, device)

    with torch.no_grad():
        dense = prefill(state, batch)  # no group: the dense projections
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with tp_group(group):
            logits = prefill(state, batch)
        torch.cuda.synchronize()
        launches = ops.launch_counts()

    steps = GROUP  # default variant: one chunk per rank
    expected = cfg.num_layers * 2 * steps  # (up, gate) per layer
    print(f"[prefill] launches in one prefill: {launches} "
          f"(expected {expected} each: {cfg.num_layers} layers x 2 "
          f"projections x {steps} steps)")
    for name, count in launches.items():
        if count != expected:
            raise AssertionError(f"{name}: {count} launches, "
                                 f"expected {expected}")
    want_shape = (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab_size)
    if tuple(logits.shape) != want_shape or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or "
                             f"not {want_shape}")
    err = _max_err(logits, dense)
    scale = dense.float().abs().max().item()
    agree = (logits.argmax(-1) == dense.argmax(-1)).float().mean().item()
    print(f"[prefill] DMA-path logits vs dense forward: max_abs_err "
          f"{err:.4e} (max |logit| {scale:.4f}, ratio {err / scale:.3e}), "
          f"argmax agreement {agree:.4f}")
    # Both paths are bf16 and differ only in the up/gate GEMMs' summation
    # order; 22 residual layers carry a one-ulp (2^-8) difference forward.
    if err > 5e-2 * scale:
        raise AssertionError(f"prefill logits differ from dense by {err}")

    with torch.no_grad():
        def run_tp():
            with tp_group(group):
                prefill(state, batch)

        def run_dense():
            prefill(state, batch)

        tokens_n = PREFILL_BATCH * PREFILL_SEQ
        for name, fn in (("DMA path", run_tp), ("dense", run_dense),
                         ("DMA path", run_tp), ("dense", run_dense)):
            ms = wall_ms(fn)
            print(f"[prefill] {PREFILL_BATCH}x{PREFILL_SEQ} tokens, {name}: "
                  f"{ms:.2f} ms wall ({tokens_n / ms * 1e3:.0f} tok/s)")
        phase_trace("DMA-path prefill", run_tp)
    return cfg, model, state, launches


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
    kernels (K1 and any)."""
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
          f"{1 - busy_us / span:.3f}); {len(k1)} K1 kernels "
          f"{total(k1_union):.2f} ms; other kernels "
          f"{total(k_union) - total(k1_union):.2f} ms; {len(copies)} memcpy "
          f"events {total(c_union):.2f} ms, of which "
          f"{_overlap(c_union, k1_union) / 1e3:.2f} ms under K1 and "
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
    kernels = phase_kernels(device, timer)
    cfg, model, state, launches = phase_prefill(device)
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
