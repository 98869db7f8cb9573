#!/usr/bin/env python3
"""Where the time of the port's wgmma GEMM goes, by taking parts out of it.

    python3 scripts/gemm_wgmma_ablation.py

Runs on one CUDA card (the kernels are built with ``nvcc`` for sm_90a).
For each ablation it copies ``src/repro_torch/kernels/csrc`` into
``build/ablation/<name>``, edits the copy of ``gemm_wgmma.cuh`` as listed
below, builds K1, K2 and K4 from the copy and times them at the main
paths' shapes (K1: 4 ranks x (512 x 2048) @ (2048 x 1408), K2: the 2D
schedule's step, an fp32 C of 4 ranks x 2048 x 1408 += (2048 x 512) @
(512 x 1408), K4: 4 ranks of 512 x 2048 shards and 2048 x 1408 weight
shards, bf16), with the L2 flushed before each run (cold, as
``chip_smoke.py`` times them) and back to back (warm).  The ablated
kernels compute wrong results on purpose (the width ablations excepted);
they are timed and nothing else.

  full          the kernel as committed
  no_products   the consumers wait for every stage and hand it back
                without a wgmma: the loads alone
  no_loads      the producer marks every stage full without a TMA load:
                the products alone, on whatever the ring holds
  no_store      the epilogue writes nothing
  no_cluster    launched without clusters: the same tiles in the same
                order, the two blocks of a pair no longer scheduled
                together
  width128      every tile 128 x 128, whatever pick_bn would choose
  width192      every tile 128 x 192, whatever pick_bn would choose
  no_c_prefetch K2's producer does not prefetch C into L2 ahead of the
                epilogue's reduce-add; K1 and K4 are unchanged
  store_not_add K2's epilogue stores its fp32 tile over C with a plain TMA
                store instead of adding it into C (L2 writes C without
                reading it); K1 and K4 are unchanged

Then one PyTorch call per kernel on the same inputs (``torch.matmul``;
``torch.baddbmm`` with an fp32 out_dtype for K2), timed the same ways, as
the yardstick.  Prints one line per ablation and, last, one
JSON object with the times.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (old, new) edits of gemm_wgmma.cuh; each old text must occur once.
_PICK = "inline int pick_bn(long long rows, long long n, int sms) {\n"
ABLATIONS = {
    "full": [],
    "no_products": [(
        "      for (int kk = 0; kk < BK / 16; ++kk)\n"
        "        mma<BN>(acc,",
        "      for (int kk = 0; kk < BK / 16; ++kk)\n"
        "        if (false) mma<BN>(acc,",
    )],
    "no_loads": [(
        "        mbar_expect_tx(full(s), C::STAGE_BYTES);\n",
        "        mbar_arrive(full(s));\n"
        "        if (++s == C::STAGES) {\n"
        "          s = 0;\n"
        "          phase ^= 1;\n"
        "        }\n"
        "        continue;\n",
    )],
    "no_store": [(
        "    store_tile<BN>(acc, tile, p,",
        "    if (acc[0] == 1234.5f) store_tile<BN>(acc, tile, p,",
    )],
    "no_cluster": [(
        "  attr[0].val.clusterDim.x = 2;",
        "  attr[0].val.clusterDim.x = 1;",
    ), (
        "    fit[dev] = n;",
        "    fit[dev] = n / 2;",
    )],
    "width128": [(_PICK, _PICK + "  return 128;\n")],
    "width192": [(_PICK, _PICK + "  return 192;\n")],
    "no_c_prefetch": [(
        "      if constexpr (Problem::ACCUMULATE) prefetch_c<BN>(p, tile);\n",
        "",
    )],
    "store_not_add": [(
        "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group",
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group",
    )],
}


def ablated_sources(name: str, edits) -> Path:
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    dst = ROOT / "build" / "ablation" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    header = dst / "gemm_wgmma.cuh"
    text = header.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: edit not found once: {old!r}")
        text = text.replace(old, new)
    header.write_text(text)
    return dst


def warm_ms(fn, n: int = 50) -> float:
    """Device ms per call of ``n`` calls back to back (L2 warm)."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gemm_wgmma_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import chunked_gemm as k1
    from repro_torch.kernels import ficco_ag_matmul as k4
    from repro_torch.parallel.sharding import shard_columns

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    device = torch.device("cuda", 0)
    randn = chip_smoke._randn_fn(device, 0)
    g, rows, d, n = (chip_smoke.GROUP,
                     chip_smoke.PREFILL_BATCH * chip_smoke.PREFILL_SEQ
                     // chip_smoke.GROUP,
                     chip_smoke.D_MODEL, chip_smoke.D_FF)
    x = randn(g, rows, d, dtype=torch.bfloat16)
    w = shard_columns(randn(d, n, dtype=torch.bfloat16, scale=d ** -0.5), g)
    out = torch.empty(g, g * rows, n // g, dtype=torch.bfloat16,
                      device=device)
    # The 2D schedule's step: C (g, g*rows, n/g) fp32 += panel (g, g*rows,
    # d/g) @ the second K slice of the weight shard.
    c = randn(g, g * rows, n // g, dtype=torch.float32)
    panel = randn(g, g * rows, d // g, dtype=torch.bfloat16)
    w_slice = w[:, d // g:2 * d // g]
    timer = chip_smoke.Timer(device)
    kernels = {
        "K1": lambda: k1._launch(x, w),
        "K2": lambda: k1._launch_accumulate(c, panel, w_slice),
        "K4": lambda: k4._launch(x, w, out, g, 2, False),
    }
    results = {}
    for name, edits in ABLATIONS.items():
        _build.SRC_DIR = ablated_sources(name, edits)
        _build._LIBS.clear()
        k1._lib.cache_clear()
        k4._lib.cache_clear()
        _build.build(("chunked_gemm", "ficco_ag_matmul"))
        results[name] = {
            kname: {"cold_ms": timer(fn), "warm_ms": warm_ms(fn)}
            for kname, fn in kernels.items()
        }
        print(f"[ablation] {name}: " + "; ".join(
            f"{k} cold {v['cold_ms']:.4f} ms, warm {v['warm_ms']:.4f} ms"
            for k, v in results[name].items()))
    library = {
        "K1": lambda: torch.matmul(x, w),
        "K2": lambda: torch.baddbmm(c, panel, w_slice,
                                    out_dtype=torch.float32),
        "K4": lambda: torch.matmul(x.view(-1, d), w),
    }
    results["library"] = {
        kname: {"cold_ms": timer(fn), "warm_ms": warm_ms(fn)}
        for kname, fn in library.items()
    }
    print("[ablation] library (torch.matmul; K2 torch.baddbmm): " + "; ".join(
        f"{k} cold {v['cold_ms']:.4f} ms, warm {v['warm_ms']:.4f} ms"
        for k, v in results["library"].items()))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ablations": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
