"""Quickstart on the PyTorch/CUDA port: the paper's contribution in 30 lines
(the port's ``examples/quickstart.py``).

1. Pick a data-dependent AG->GEMM scenario (Table I),
2. let the FiCCO heuristic choose a bespoke overlap schedule,
3. compare the full design space with the batched simulator — on any
   engine of ``repro_torch.core.engine`` (``"torch"`` and ``"mixed"``
   evaluate on ``--device``),
4. run the numerically-exact schedule over 8 logical tensor-parallel
   ranks (``TPGroup(8)``) on ``--device``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
      [--backend mixed|numpy|scalar|torch]
      [--machine h100-sxm-8|mi300x-8|tpu-v5e-axis16]
      [--schedule auto|autotune] [--device cpu]

Everything runs on the card unless ``--device cpu`` is given; with no
CUDA device and no ``--device cpu`` the example raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    MACHINES, SCENARIOS, engine_names, explore_grid, select_schedule,
)
from repro_torch.core.engine import MixedEngine, TorchEngine
from repro_torch.device import resolve_device
from repro_torch.overlap.api import ficco_linear
from repro_torch.parallel.sharding import TPGroup, shard_columns, tp_group

GROUP = 8
DEVICE_ENGINES = {"torch": TorchEngine, "mixed": MixedEngine}


def grid_engine(backend: str, device: torch.device) -> dict:
    """``explore_grid``'s engine keyword: an engine that evaluates on a
    device is built on ``device``; the host engines go by name."""
    if backend in DEVICE_ENGINES:
        return {"engine": DEVICE_ENGINES[backend](device=device)}
    return {"backend": backend}


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", choices=engine_names(), default="numpy",
                    help="grid engine from the repro_torch.core.engine "
                    "registry")
    ap.add_argument("--machine", choices=sorted(MACHINES),
                    default="mi300x-8")
    ap.add_argument("--schedule", choices=("auto", "autotune"),
                    default="auto",
                    help="auto: static heuristic; autotune: cached runtime "
                    "tuner")
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                    "cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    machine = MACHINES[args.machine]

    scenario = SCENARIOS["g9"]  # llama-3-405b QKV projection under SP+TP
    print(f"scenario {scenario.name}: GEMM {scenario.gemm} "
          f"({scenario.parallelism}, {scenario.model})")

    # --- 1+2: static heuristic pick (paper Fig. 12a + learned serial gate)
    dec = select_schedule(scenario.gemm, machine)
    print(f"heuristic -> {dec.schedule.value}   ({dec.reason})")

    # --- 3: full design-space exploration on the chosen backend ---------
    ex = explore_grid([scenario], machines=[machine],
                      **grid_engine(args.backend, device))
    grid = ex.grid
    order = np.argsort(np.where(grid.valid[:, 0, 0], grid.total[:, 0, 0],
                                np.inf))
    print(f"ranking on {machine.name} via the {args.backend} engine:")
    for l in order:
        if not grid.valid[l, 0, 0]:
            continue
        sched = grid.schedules[int(l)]
        mark = " <- heuristic" if sched is dec.schedule else ""
        print(f"  {sched.value:20s} speedup "
              f"{grid.speedup[l, 0, 0]:5.2f}x{mark}")

    # --- 4: execute the schedule exactly (8 logical ranks) --------------
    rng = np.random.default_rng(0)
    x = torch.from_numpy(  # M-sharded: rank r's rows at [r]
        rng.standard_normal((512, 256)).astype(np.float32)).to(device)
    w = torch.from_numpy(  # N-sharded: rank r's columns at [r]
        rng.standard_normal((256, 256)).astype(np.float32)).to(device)
    with tp_group(TPGroup(GROUP, device)):
        per_rank = ficco_linear(
            x.view(GROUP, -1, x.shape[1]), shard_columns(w, GROUP),
            schedule=args.schedule, machine=machine,
        )
    # (g, M, N/g) -> (M, N): rank r's columns in place, P(None, "tp").
    out = per_rank.permute(1, 0, 2).reshape(x.shape[0], w.shape[1])
    np.testing.assert_allclose(
        out.cpu().numpy(), (x @ w).cpu().numpy(), rtol=1e-3, atol=1e-3
    )
    print(f"ficco_linear({args.schedule}) == serial oracle: OK  "
          f"(out {tuple(out.shape)})")
    return out


if __name__ == "__main__":
    main()
