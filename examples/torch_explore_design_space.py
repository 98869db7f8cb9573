"""Design-space exploration (the paper's headline contribution) on the
PyTorch/CUDA port's analytic core (the port's
``examples/explore_design_space.py``).

Walks all Table-I scenarios + the 8-variant space, prints per-scenario
rankings, the pruning argument (§V-B), and heuristic accuracy — then does
the same on the TPU v5e machine model to show what changes on a torus.
Finishes with the batched engine: the full registry-arch scenario grid x
machine grid in one vectorized call, on the NumPy engine, the scalar
simulator loop, or the card's ``"torch"`` (float64) or ``"mixed"``
(float32) engine.

Run:  PYTHONPATH=src python examples/torch_explore_design_space.py \
          [--backend mixed|numpy|scalar|torch] [--device cpu]

The ``"torch"`` and ``"mixed"`` engines evaluate on ``--device``, the
card unless ``--device cpu`` is given; with no CUDA device and no
``--device cpu`` the example raises.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (
    MI300X, TABLE_I, TPU_V5E, explore_grid, geomean, machine_grid,
    prune_report, scenario_grid,
)
from repro_torch.core.engine import MixedEngine, TorchEngine
from repro_torch.device import resolve_device

BACKENDS = ("mixed", "numpy", "scalar", "torch")
DEVICE_ENGINES = {"torch": TorchEngine, "mixed": MixedEngine}


def grid_engine(backend: str, device: torch.device) -> dict:
    """``explore_grid``'s engine keyword: an engine that evaluates on a
    device is built on ``device``; the host engines go by name."""
    if backend in DEVICE_ENGINES:
        return {"engine": DEVICE_ENGINES[backend](device=device)}
    return {"backend": backend}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", choices=BACKENDS, default="numpy",
                    help="grid engine from the repro_torch.core.engine "
                    "registry")
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                    "cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    engine = grid_engine(args.backend, device)

    for machine in (MI300X, TPU_V5E):
        print(f"\n===== {machine.name} ({machine.topology.value}) =====")
        ex = explore_grid(TABLE_I, machines=(machine,), **engine)
        best_vals = []
        for i, sc in enumerate(TABLE_I):
            best_l = int(ex.best_idx[i, 0])
            heur_l = int(ex.heuristic_idx[i, 0])
            best = ex.grid.schedules[best_l]
            heur = ex.grid.schedules[heur_l]
            speedup = float(ex.grid.speedup[best_l, i, 0])
            best_vals.append(speedup)
            ok = "OK " if bool(ex.exact[i, 0]) else (
                "~ok" if bool(ex.within(0.05)[i, 0]) else "MISS"
            )
            print(f"{sc.name:4s} best={best.value:18s} "
                  f"{speedup:4.2f}x heur={heur.value:18s} {ok}")
        print(f"geomean best speedup: {geomean(best_vals):.3f}")

    print("\n===== pruning argument (g2, all 8 variants) =====")
    for name, t, studied in prune_report(TABLE_I[1], MI300X):
        tag = "studied" if studied else "pruned "
        print(f"  {tag} {name:22s} {t*1e3:8.2f} ms")

    # ===== batched engine: the whole design space in three lines =======
    scenarios = scenario_grid()
    machines = machine_grid()
    if "engine" in engine and device.type == "cuda":
        # One untimed call first: the card's first evaluation pays for
        # the CUDA context and the allocator's first blocks.
        explore_grid(scenarios, machines=machines, **engine)
    t0 = time.perf_counter()
    ex = explore_grid(scenarios, machines=machines, **engine)
    dt = time.perf_counter() - t0
    print(f"\n===== batched grid ({args.backend}): {len(scenarios)} "
          f"scenarios x {len(machines)} machines in {dt*1e3:.0f} ms =====")
    print(ex.summary())
    return ex


if __name__ == "__main__":
    main()
