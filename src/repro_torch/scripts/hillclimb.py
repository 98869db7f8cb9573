"""Hillclimbing driver: hypothesis -> change -> dry-run -> compare.

Runs a named sequence of config variants through the dry-run
(:func:`repro_torch.launch.dryrun.dryrun_one`) for one of three chosen
(arch x shape) pairs and prints each variant's roofline terms.  Each
variant carries an explicit hypothesis; the JSON output keeps the
results beside them.

Usage:
  PYTHONPATH=src python -m repro_torch.scripts.hillclimb --pair yi_decode \\
      [--json results.json]

Port of the reference's ``scripts/hillclimb.py``: the same pairs,
variants and transforms.  ``CACHE_BATCH_ONLY``, ``CACHE_HEADDIM`` and
``WEIGHTS_NO_FSDP`` replace :mod:`repro_torch.parallel.sharding`'s
``cache_leaf_spec`` or ``fix_param_spec`` for their variant and restore
them after.  The analytic prepass runs the port's ``explore_grid`` on
``H100_SXM`` at the production mesh's model-axis size.  The hypotheses
keep the reference's reasoning without the figures its TPU runs gave.
The process exits 1 if a variant fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import traceback

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.explorer import explore_grid
from repro_torch.core.machine import H100_SXM, machine_for_group
from repro_torch.core.workload import tp_gemms, tp_token_rows
from repro_torch.launch.dryrun import dryrun_one
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import MODEL_AXIS, P


def _analytic_prepass(arch: str, shape_name: str) -> None:
    """Batched FiCCO pre-pass: sweep the pair's data-dependent AG->GEMMs
    through the design-space engine (one ``explore_grid`` call) and print
    the predicted best schedule and speedup per GEMM on the production
    mesh's tensor-parallel group."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    g = make_production_mesh().shape[MODEL_AXIS]
    m = tp_token_rows(shape.global_batch, shape.seq_len)
    gemms = tp_gemms(cfg, m)
    ex = explore_grid(list(gemms.values()),
                      machines=(machine_for_group(H100_SXM, g),))
    best_total = ex.grid.best_total()
    print(f"##### analytic prepass: {arch} x {shape_name} (g={g}, H100)")
    for i, name in enumerate(gemms):
        best = ex.grid.schedules[int(ex.best_idx[i, 0])]
        pick = ex.grid.schedules[int(ex.heuristic_idx[i, 0])]
        sp = ex.grid.serial_total[i, 0] / best_total[i, 0]
        print(
            f"  {name:14s} best={best.value:18s} {sp:4.2f}x "
            f"heuristic={pick.value}"
        )


def _no_remat(cfg):
    return dataclasses.replace(cfg, remat=False)


def _remat_dots(cfg):
    return dataclasses.replace(cfg, remat_policy="dots")


def _sm_decode(cfg):
    return dataclasses.replace(
        cfg, overlap=dataclasses.replace(cfg.overlap, decode_attn="shard_map")
    )


PAIRS = {
    # (1) Most representative of the paper's technique and the most
    # collective-bound train pair: DeepSeek EP (Table I g13 is DeepSeek).
    "deepseek_train": {
        "arch": "deepseek-v2-lite-16b",
        "shape": "train_4k",
        "variants": [
            ("baseline_gspmd_serial", None,
             "Baseline: collective-dominated (MoE dispatch all-to-alls + "
             "MLA TP collectives): the collective term above the compute "
             "term."),
            ("ficco_auto", {"overlap": "ficco_auto"},
             "HYPOTHESIS (paper-faithful FiCCO): shared-expert/TP MLP "
             "AG->GEMMs run heuristic FiCCO schedules -> chunked "
             "all-gathers (count x16, each 1/16 size) that can be "
             "pipelined; total collective bytes ~unchanged, exposure "
             "structurally reduced."),
            ("accum4", {"accum_steps": 4},
             "HYPOTHESIS (beyond-paper): 4-way grad-accumulation cuts live "
             "dispatch/activation buffers ~4x; collective bytes unchanged "
             "(same tokens), memory/device must drop several-fold."),
            ("no_remat", _no_remat,
             "HYPOTHESIS: dropping remat removes the recomputed forward "
             "(~25% of compute term) but inflates live activations; for "
             "this memory-stressed pair that is the wrong direction — "
             "expect refutation as a useful negative result."),
            ("remat_dots", _remat_dots,
             "HYPOTHESIS (from the no_remat finding: remat re-runs the "
             "collectives): dots_saveable keeps GEMM outputs so the "
             "backward skips GEMM+collective recompute — the collective "
             "term should approach no_remat's at far less memory than "
             "no_remat's."),
            ("ficco_accum4", {"overlap": "ficco_auto", "accum_steps": 4},
             "COMBINED best: paper technique + microbatching."),
        ],
    },
    # (2) The most collective-bound decode pair: yi-9b decode_32k
    # (context-sharded KV cache reads).
    "yi_decode": {
        "arch": "yi-9b",
        "shape": "decode_32k",
        "variants": [
            ("baseline", None,
             "Baseline: KV cache time-sharded over model axis -> "
             "attention partials all-reduced every step."),
            ("cache_batch_only", "CACHE_BATCH_ONLY",
             "HYPOTHESIS: batch-only cache sharding removes the "
             "context-parallel reduction collectives entirely "
             "(collective term down ~10x) at ~16x per-device cache bytes "
             "(expect memory to explode: trade-off quantified)."),
            ("ficco_auto", {"overlap": "ficco_auto"},
             "HYPOTHESIS: decode-step GEMMs (128 rows) are below the "
             "decomposition guard -> FiCCO correctly stays serial; "
             "no regression."),
            ("weights_no_fsdp", "WEIGHTS_NO_FSDP",
             "HYPOTHESIS (from the baseline breakdown: the all-gathers are "
             "ZeRO-3 weight gathering, absurd for decode): replicating "
             "params over the data axis (TP-only weight sharding, +~1GiB/dev "
             "for 9B params) should remove most of the all-gather volume "
             "-> collective term down several-fold."),
            ("shard_map_flash_decode", _sm_decode,
             "HYPOTHESIS (from headdim/batch-only refutations: an implicit "
             "partitioner cannot keep the scores->softmax->AV chain "
             "distributed): an EXPLICIT shard_map flash-decode — local "
             "partial softmax + pmax/psum of (B,H)-sized statistics — "
             "removes the K/V gathers entirely: collective bytes should "
             "drop from gigabyte-scale gathers to megabyte-scale psums "
             "(the same explicit-decomposition move FiCCO makes for "
             "GEMMs)."),
            ("headdim_cache", "CACHE_HEADDIM",
             "HYPOTHESIS: sharding the KV cache on head_dim (128/16=8) "
             "instead of the 32k time axis makes the in-place cache "
             "update shard-local and turns attention into a cheap "
             "partial-sum all-reduce of (B,H,1,S) scores instead of "
             "gathering K/V slices."),
        ],
    },
    # (3) The worst-fit pair: Jamba train (activations of 72 layers x 8192
    # width + MoE dispatch far beyond a device's memory).
    "jamba_train": {
        "arch": "jamba-1.5-large-398b",
        "shape": "train_4k",
        "variants": [
            ("baseline", None,
             "Baseline: memory far over a device's HBM."),
            ("accum4", {"accum_steps": 4},
             "HYPOTHESIS: 4-way microbatching divides live activations "
             "~4x; compute/collective terms unchanged (same total work)."),
            ("accum8", {"accum_steps": 8},
             "HYPOTHESIS: 8-way halves memory again vs accum4 with "
             "diminishing returns once weights+moments dominate."),
        ],
    },
}


def _batch_only(orig):
    def batch_only(shape, mesh):
        sp = orig(shape, mesh)
        entries = [
            e if (isinstance(e, tuple) and "model" not in e)
            or (e != "model")
            else None
            for e in sp
        ]
        return P(*entries)

    return batch_only


def _headdim(orig):
    def headdim(shape, mesh):
        model = mesh.shape.get("model", 1)
        if len(shape) == 5 and shape[-1] % model == 0:
            # (periods, B, S, KV, hd): batch + head_dim sharding
            sp = list(orig(shape, mesh))
            sp += [None] * (5 - len(sp))
            sp[2] = None  # drop time-axis sharding
            sp[4] = "model"
            return P(*sp)
        return orig(shape, mesh)

    return headdim


def _no_fsdp(orig):
    def no_fsdp(spec, shape, mesh, *, fsdp_axis="data"):
        return orig(spec, shape, mesh, fsdp_axis="__none__")

    return no_fsdp


# The variants that replace a spec rule in the sharding module: (name of
# the rule, the replacement built from the original).
PATCHES = {
    "CACHE_BATCH_ONLY": ("cache_leaf_spec", _batch_only),
    "CACHE_HEADDIM": ("cache_leaf_spec", _headdim),
    "WEIGHTS_NO_FSDP": ("fix_param_spec", _no_fsdp),
}


def run_variant(arch: str, shape: str, transform) -> dict:
    """One variant through the dry-run: ``transform`` is None, a config
    transform, a dict of ``dryrun_one`` arguments (``overlap``,
    ``accum_steps``) or a key of :data:`PATCHES`."""
    kw, t, patch = {}, transform, None
    if isinstance(transform, dict):
        kw, t = dict(transform), None
    elif isinstance(transform, str):
        patch, t = PATCHES[transform], None
    orig = None
    if patch is not None:
        name, make = patch
        orig = getattr(sharding, name)
        setattr(sharding, name, make(orig))
    try:
        overlap = kw.pop("overlap", "gspmd_serial")
        return dryrun_one(arch, shape, overlap=overlap, transform=t,
                          extrapolate=True, **kw)
    except Exception as e:
        traceback.print_exc()
        return {"ok": False, "error": str(e)}
    finally:
        if orig is not None:
            setattr(sharding, patch[0], orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", choices=sorted(PAIRS), required=True)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    spec = PAIRS[args.pair]

    _analytic_prepass(spec["arch"], spec["shape"])

    results = []
    for name, transform, hypothesis in spec["variants"]:
        print(f"\n##### variant {name}: {hypothesis}\n", flush=True)
        r = run_variant(spec["arch"], spec["shape"], transform)
        r["variant"] = name
        r["hypothesis"] = hypothesis
        results.append(r)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print("\n===== summary =====")
    for r in results:
        if not r.get("ok"):
            print(f"{r['variant']}: FAILED {r.get('error', '')[:80]}")
            continue
        counts = r["collective_counts"]
        print(
            f"{r['variant']:24s} compute={r['t_compute']*1e3:9.2f}ms "
            f"memory={r['t_memory']*1e3:8.2f}ms "
            f"collective={r['t_collective']*1e3:8.2f}ms "
            f"mem/dev={r['bytes_per_device']/2**30:6.2f}GiB "
            f"AGs={counts.get('all-gather', 0)}"
        )
    return 0 if all(r.get("ok") for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
