"""The port's dry-run (``repro_torch.launch.dryrun``) against the reference's.

The sharding specs are held to the reference's entry for entry: every
arch's ``param_specs()``, ``fix_param_specs`` on three meshes and the
decode caches' ``cache_specs``, all computed by the reference's spec
functions in the session's one JAX subprocess (its ``dryrun`` entry,
``tests/torch_jax_reference.py``).  The port's per-device argument bytes
equal the ``argument_size_in_bytes`` of the reference's compiled steps of
the reduced TinyLlama and xLSTM on 4 forced host devices as (data 2,
model 2).  The reference's decode and MoE dry-runs do not compile on this
tree (ROADMAP R8), so those are held to the spec functions only.

The collectives are the port's own count (an FSDP + tensor-parallel
deployment, not GSPMD's choices): each rule is held to a count by hand on
a one-layer config.  The command lines run in process.
"""

import copy
import dataclasses
import json
import math
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch_jax_reference as jax_reference

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P
from repro_torch.roofline import analysis, counters
from repro_torch.scripts import hillclimb
from repro_torch.train.optimizer import state_specs
from repro_torch.tree import leaves

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ALL_ARCHS = sorted(ARCHS)
MESHES = [Mesh(tuple(m), tuple(m.values()))
          for m in jax_reference.DRYRUN["meshes"]]
SMALL = Mesh(("data", "model"), (2, 2))


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    """The JAX subprocess runs while the in-process tests run."""
    jax_reference.start(tmp_path_factory)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference.reference(tmp_path_factory, entry="dryrun")


def paths(tree) -> dict:
    """A spec tree as the subprocess flattens the reference's."""
    flat = []

    def walk(t, path):
        if isinstance(t, P):
            flat.append((path, t))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], [*path, k])
        else:
            for i, v in enumerate(t):
                walk(v, [*path, i])

    walk(tree, [])
    return jax_reference.spec_paths(flat)


def test_cache_leaf_spec_joins_data_to_time_when_batch_is_unsharded():
    mesh = make_production_mesh()
    # long_500k: B = 1 cannot shard, so data joins the time axis
    assert sharding.cache_leaf_spec((9, 1, 524288, 8, 128), mesh) == P(
        None, None, ("data", "model"), None, None)
    assert sharding.cache_leaf_spec((9, 128, 32768, 8, 128), mesh) == P(
        None, "data", "model", None, None)
    pods = make_production_mesh(multi_pod=True)
    assert sharding.cache_leaf_spec((9, 128, 32768, 8, 128), pods) == P(
        None, ("pod", "data"), "model", None, None)
    assert sharding.cache_leaf_spec((9, 1, 524288, 8, 128), pods) == P(
        None, None, ("pod", "data", "model"), None, None)


def test_shard_shape_and_state_specs():
    mesh = make_production_mesh(multi_pod=True)
    assert sharding.shard_shape(P(None, ("pod", "data"), "model"),
                                (3, 64, 48), mesh) == (3, 2, 3)
    assert sharding.shard_shape(P("absent"), (5, 7), mesh) == (5, 7)
    pspecs = {"w": P(None, "model")}
    assert state_specs(pspecs) == {"m": pspecs, "v": pspecs, "step": P()}
    assert tuple(P("a", None)) == ("a", None) and repr(P()) == "P()"
    spec = P(("pod", "data"), None)
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert type(copy.deepcopy(spec)) is P


def test_meshes():
    mesh = make_production_mesh()
    assert (mesh.shape, mesh.size, mesh.name) == (
        {"data": 16, "model": 16}, 256, "16x16")
    pods = make_production_mesh(multi_pod=True)
    assert list(pods.shape) == ["pod", "data", "model"]
    assert (pods.size, pods.name) == (512, "2x16x16")
    assert make_host_mesh(devices=1).shape == {"data": 1, "model": 1}
    assert make_host_mesh(2, devices=8).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        make_host_mesh(3, devices=8)


# ---------------------------------------------------------------------------
# The collective rules, counted by hand on one layer at (data 2, model 2)
# ---------------------------------------------------------------------------

SEQ, BATCH = 64, 8


def _one_layer(arch="tinyllama-1.1b", **changes):
    return dataclasses.replace(get_config(arch).reduced(), num_layers=1,
                               **changes)


def _collectives(cfg, kind, mesh=SMALL, seq=SEQ, **kw):
    shape = ShapeConfig("t", seq, BATCH, kind)
    args = dryrun.step_arguments(cfg, shape, mesh)
    stats = dryrun.step_collectives(cfg, shape, mesh, args, **kw)
    return stats.bytes_by_kind, stats.count_by_kind


def _tiny_counts():
    """The one-layer reduced TinyLlama at (2, 2): every weight of 2^16
    elements or more takes FSDP over data (its norms stay replicated)."""
    cfg = _one_layer()
    d, ff, v, item = cfg.d_model, cfg.d_ff, cfg.vocab_size, 4
    assert cfg.num_kv_heads * cfg.resolved_head_dim == d
    tokens = BATCH // 2 * SEQ  # the rows of one device's batch shard
    # embed, unembed, wq wk wv wo, w_up w_gate w_down, each gathered over
    # data to its model shard
    gathered = item * (2 * v * d + 4 * d * d + 3 * d * ff) // 2
    act = tokens * d * item  # one (tokens, d_model) activation
    return cfg, tokens, gathered, act, d * item


def test_prefill_rules_fsdp_gathers_and_row_parallel_all_reduces():
    cfg, _, gathered, act, _ = _tiny_counts()
    nbytes, count = _collectives(cfg, "prefill")
    assert count == {"all-gather": 9, "all-reduce": 3}
    # the embedding lookup, wo and w_down
    assert nbytes == {"all-gather": gathered, "all-reduce": 3 * act}


def test_train_rules_add_the_backward_and_the_gradient_reductions():
    cfg, tokens, gathered, act, norm = _tiny_counts()
    nbytes, count = _collectives(cfg, "train")
    # all-reduce: 3 forward (lookup, wo, w_down); 6 input gradients (wq,
    # wk, wv, w_up, w_gate, unembed); the loss's max, sum and gold logit;
    # the gradients of 3 replicated norms
    assert count == {"all-gather": 18, "reduce-scatter": 9,
                     "all-reduce": 15}
    assert nbytes == {"all-gather": 2 * gathered,
                      "reduce-scatter": gathered // 2,
                      "all-reduce": 9 * act + 3 * tokens * 4 + 3 * norm}
    # remat runs the period's forward again: its 7 weights are gathered a
    # third time and wo, w_down all-reduce again; "dots" keeps them
    nbytes_r, count_r = _collectives(dataclasses.replace(cfg, remat=True),
                                     "train")
    assert count_r["all-gather"] == 18 + 7
    assert count_r["all-reduce"] == 15 + 2
    assert nbytes_r["all-reduce"] == nbytes["all-reduce"] + 2 * act
    assert _collectives(dataclasses.replace(cfg, remat=True,
                                            remat_policy="dots"),
                        "train") == (nbytes, count)
    # microbatches: the weights gathered and the activations reduced per
    # microbatch (at a quarter of the tokens), the gradients once
    nbytes_a, count_a = _collectives(cfg, "train", accum_steps=4)
    assert count_a == {"all-gather": 72, "reduce-scatter": 9,
                       "all-reduce": 4 * 12 + 3}
    assert nbytes_a["all-gather"] == 8 * gathered
    assert nbytes_a["all-reduce"] == nbytes["all-reduce"]


def test_moe_layers_add_dispatch_and_combine_all_to_alls():
    cfg = _one_layer("deepseek-v2-lite-16b")
    moe = cfg.moe
    tokens = BATCH // 2 * SEQ
    capacity = int(max(moe.capacity_factor * tokens * moe.top_k
                       / moe.num_experts, 4))
    per_call = moe.num_experts // 2 * capacity * cfg.d_model * 4
    nbytes, count = _collectives(cfg, "prefill")
    assert (count["all-to-all"], nbytes["all-to-all"]) == (2, 2 * per_call)
    nbytes, count = _collectives(cfg, "train")  # and their transposes
    assert (count["all-to-all"], nbytes["all-to-all"]) == (4, 4 * per_call)


def test_decode_gathers_the_time_sharded_cache_or_combines_flash_stats():
    cfg, _, gathered, _, _ = _tiny_counts()
    s = 2048  # >= 1024: the cache's time axis over model
    b_local = BATCH // 2
    kv, hd, h = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads
    nbytes, count = _collectives(cfg, "decode", seq=s)
    assert count["all-gather"] == 9 + 2  # the weights, then K and V
    assert nbytes["all-gather"] == gathered + 2 * b_local * s * kv * hd * 4
    flash = dataclasses.replace(
        cfg, overlap=dataclasses.replace(cfg.overlap,
                                         decode_attn="shard_map"))
    nbytes_f, count_f = _collectives(flash, "decode", seq=s)
    assert (count_f["all-gather"], nbytes_f["all-gather"]) == (9, gathered)
    assert count_f["all-reduce"] == count["all-reduce"] + 3
    assert nbytes_f["all-reduce"] == (nbytes["all-reduce"]
                                      + b_local * h * (2 + hd) * 4)


def test_ficco_site_adds_what_counting_records():
    cfg, _, _, act, _ = _tiny_counts()
    base = _collectives(cfg, "prefill")
    serial = dataclasses.replace(
        cfg, overlap=dataclasses.replace(cfg.overlap, mode="serial"))
    nbytes, count = _collectives(serial, "prefill")
    # up and gate each all-gather the sequence-sharded activation
    assert count["all-gather"] == base[1]["all-gather"] + 2
    assert nbytes["all-gather"] == base[0]["all-gather"] + 2 * act
    assert (nbytes["all-reduce"], count["all-reduce"]) == (
        base[0]["all-reduce"], base[1]["all-reduce"])
    auto = dataclasses.replace(
        cfg, overlap=dataclasses.replace(cfg.overlap, mode="ficco_auto"))
    assert _collectives(auto, "prefill")[1]["all-gather"] > 9


def test_one_device_issues_no_collective_and_holds_everything():
    cfg = _one_layer()
    mesh = make_host_mesh(devices=1)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("t", SEQ, BATCH, kind)
        args = dryrun.step_arguments(cfg, shape, mesh)
        stats = dryrun.step_collectives(cfg, shape, mesh, args)
        assert stats.bytes_by_kind == {} and stats.count_by_kind == {}
        whole = sum(math.prod(leaf.shape) * leaf.dtype.itemsize
                    for tree, _ in args.values() for leaf in leaves(tree))
        assert dryrun.per_device_bytes(args, mesh) == whole


# ---------------------------------------------------------------------------
# The dry-run, its command line and the hillclimb driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_dryrun_one_every_shape_on_the_production_mesh(arch):
    for name, shape in SHAPES.items():
        r = dryrun.dryrun_one(arch, name, verbose=False)
        cfg = dryrun.prepared_config(arch, shape, "gspmd_serial")
        costs = counters.step_costs(cfg, shape, shape.kind)
        assert r["ok"] and r["mesh"] == "16x16" and r["chips"] == 256
        assert (r["hlo_flops"], r["hlo_bytes"]) == (costs.flops, costs.bytes)
        assert r["model_flops"] == analysis.model_flops_for(cfg, shape,
                                                            shape.kind)
        assert r["bytes_per_device"] == (r["argument_bytes"]
                                         + r["output_bytes"])
        assert r["collective_bytes"] > 0 and r["t_collective"] > 0


def test_moments_in_bf16_above_1e11_parameters():
    mesh = make_production_mesh()
    for arch, want in (("arctic-480b", torch.bfloat16),
                       ("jamba-1.5-large-398b", torch.bfloat16),
                       ("internvl2-76b", torch.float32)):
        args = dryrun.step_arguments(get_config(arch), SHAPES["train_4k"],
                                     mesh)
        moments = leaves(args["opt_state"][0])
        assert {s.dtype for s in moments} == {want, torch.int32}, arch


def test_command_line_and_its_json_render(tmp_path, capsys):
    one, pods = tmp_path / "one.json", tmp_path / "pods.json"
    assert dryrun.main(["--all", "--json", str(one)]) == 0
    assert dryrun.main(["--all", "--multi-pod", "--no-extrapolate",
                        "--json", str(pods)]) == 0
    assert "40/40 dry-runs passed" in capsys.readouterr().out
    rows = json.loads(one.read_text())
    assert len(rows) == 40 and all(r["ok"] for r in rows)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "make_experiments_md.py"),
         str(one), str(pods)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "| tinyllama-1.1b | train_4k |" in proc.stdout
    assert "40/40 lower+compile passed" in proc.stdout


def test_hillclimb_runs_a_pair_and_restores_the_rules(tmp_path, capsys):
    rules = (sharding.cache_leaf_spec, sharding.fix_param_spec)
    out = tmp_path / "yi.json"
    assert hillclimb.main(["--pair", "yi_decode", "--json", str(out)]) == 0
    assert (sharding.cache_leaf_spec, sharding.fix_param_spec) == rules
    rows = {r["variant"]: r for r in json.loads(out.read_text())}
    assert all(r["ok"] for r in rows.values())
    base = rows["baseline"]
    # the patched rules reach the dry-run: batch-only caches hold 16 x the
    # bytes and read no gathered cache; no FSDP gathers no weight
    assert (rows["cache_batch_only"]["collective_counts"]["all-gather"]
            < base["collective_counts"]["all-gather"])
    assert (rows["cache_batch_only"]["bytes_per_device"]
            > 10 * base["bytes_per_device"])
    assert (rows["weights_no_fsdp"]["collective_counts"]["all-gather"]
            < base["collective_counts"]["all-gather"])
    assert (rows["shard_map_flash_decode"]["collective_bytes"]
            < base["collective_bytes"] / 100)
    assert "analytic prepass: yi-9b x decode_32k (g=16, H100)" in (
        capsys.readouterr().out)


# ---------------------------------------------------------------------------
# Against the reference (last: the JAX subprocess works while the tests
# above run)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_reference(arch, ref):
    specs_ = build_model(get_config(arch)).param_specs()
    assert paths(specs_) == ref["param_specs"][arch]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_fixed_param_specs_match_reference(arch, ref):
    cfg = get_config(arch)
    specs_ = build_model(cfg).param_specs()
    for i, mesh in enumerate(MESHES):
        fixed = sharding.fix_param_specs(specs_, analysis.meta_state(cfg),
                                         mesh)
        assert paths(fixed) == ref["fixed"][arch, i], mesh


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_match_reference(arch, ref):
    for name in jax_reference.DRYRUN["caches"]:
        shape = SHAPES[name]
        cfg = dryrun.prepared_config(arch, shape, "gspmd_serial")
        cache = specs.decode_specs(cfg, shape)["cache"]
        for i, mesh in enumerate(MESHES):
            got = paths(sharding.cache_specs(cache, mesh))
            assert got == ref["cache"][arch, name, i], (name, mesh)


@pytest.mark.parametrize("arch, kind", [
    (a, k) for a in jax_reference.DRYRUN["compiled"]
    for k in jax_reference.DRYRUN["kinds"]])
def test_argument_bytes_equal_the_compiled_steps(arch, kind, ref):
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("t", jax_reference.DRYRUN["seq"],
                        jax_reference.DRYRUN["batch"], kind)
    args = dryrun.step_arguments(cfg, shape, SMALL)
    assert dryrun.per_device_bytes(args, SMALL) == ref["compiled"][arch,
                                                                   kind][0]
