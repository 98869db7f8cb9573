"""The port stands alone: it imports no JAX and nothing of ``repro``, and
its entry points refuse to run on a missing CUDA device unless the caller
asks for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

_ROOT = Path(__file__).resolve().parents[1]
_PKG = _ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(_PKG.rglob("*.py")):
        rel = path.relative_to(_PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _port_examples():
    return sorted(str(p) for p in (_ROOT / "examples").glob("torch_*.py"))


def test_examples_import_no_jax_and_no_reference():
    code = (
        "import importlib.util, sys\n"
        f"for path in {_port_examples()!r}:\n"
        "    spec = importlib.util.spec_from_file_location('ex', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert len(_port_examples()) == 4
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _tiny():
    from repro_torch.configs import get_config

    return get_config("tinyllama-1.1b").reduced()


def _model_init():
    from repro_torch.models.model import build_model

    build_model(_tiny()).init(0)


def _init_cache():
    from repro_torch.models.model import build_model

    build_model(_tiny()).init_cache(2, 16)


def _tp_group():
    from repro_torch.parallel.sharding import TPGroup

    TPGroup(4)


def _decode_engine():
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import DecodeEngine

    cfg = _tiny()
    DecodeEngine(cfg, build_model(cfg).init(0, device="cpu"))


def _params_from_jax():
    from repro_torch.convert import params_from_jax

    params_from_jax({"embed": np.zeros((2, 2)), "layers": [{}]}, _tiny())


def _launch_serve():
    from repro_torch.launch.serve import main

    main(["--arch", "tinyllama-1.1b", "--prompts", "1", "--new-tokens", "1"])


def _init_train_state():
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import init_train_state

    init_train_state(build_model(_tiny()), 0)


def _make_pipeline():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_pipeline

    make_pipeline(_tiny(), ShapeConfig("t", 8, 2, "train"))


def _opt_state_from_jax():
    from repro_torch.convert import opt_state_from_jax

    opt_state_from_jax({"m": {}, "v": {}, "step": np.int32(0)}, _tiny())


def _train():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.loop import train

    train(_tiny(), ShapeConfig("t", 8, 2, "train"), steps=1)


def _launch_train():
    from repro_torch.launch.train import main

    main(["--arch", "tinyllama-1.1b", "--steps", "1"])


def _torch_engine():
    from repro_torch.core.engine import get_engine
    from repro_torch.core.machine import H100_SXM
    from repro_torch.core.workload import TABLE_I

    get_engine("torch").evaluate(TABLE_I, [H100_SXM])


def _fit_machine():
    from repro_torch.core.machine import H100_SXM
    from repro_torch.core.schedule_types import Schedule
    from repro_torch.core.workload import GemmShape
    from repro_torch.learn import MeasuredRecord, fit_machine

    fit_machine(H100_SXM, [MeasuredRecord(GemmShape(2048, 5632, 2048, 2),
                                          Schedule.SERIAL, 1e-4, 8)])


def _adaptive_tier():
    from repro_torch.serve.adapt import AdaptiveTier

    AdaptiveTier()


def _seamless():
    from repro_torch.configs import get_config

    return get_config("seamless-m4t-large-v2").reduced()


def _init_cache_enc_len():
    from repro_torch.models.model import build_model

    build_model(_seamless()).init_cache(2, 16, enc_len=4)


def _decode_engine_enc_len():
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import DecodeEngine

    cfg = _seamless()
    DecodeEngine(cfg, build_model(cfg).init(0, device="cpu"), enc_len=4)


def _launch_serve_encdec():
    from repro_torch.launch.serve import main

    main(["--arch", "seamless-m4t-large-v2", "--prompts", "1",
          "--new-tokens", "1"])


def _launch_train_moe():
    from repro_torch.launch.train import main

    main(["--arch", "deepseek-v2-lite-16b", "--steps", "1"])


def _init_cache_jamba():
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    build_model(get_config("jamba-1.5-large-398b").reduced()).init_cache(2, 16)


def _launch_serve_xlstm():
    from repro_torch.launch.serve import main

    main(["--arch", "xlstm-1.3b", "--prompts", "1", "--new-tokens", "1"])


def _mixed_engine():
    from repro_torch.core.engine import MixedEngine
    from repro_torch.core.machine import H100_SXM
    from repro_torch.core.workload import TABLE_I

    MixedEngine().evaluate(TABLE_I, [H100_SXM])


def _sweep_device_stats():
    from repro_torch.core.workload import machine_grid
    from repro_torch.sweep import sweep_device_stats

    sweep_device_stats(8, machine_grid(groups=(8,)))


def _device_batch():
    from repro_torch.sweep import device_batch

    device_batch(8)


def _sweep_cli():
    from repro_torch.scripts.sweep import main

    main(["--scenarios", "8"])


def _host_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    make_host_mesh()


def _example(name):
    def run():
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            name, _ROOT / "examples" / f"torch_{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main([])
    return run


ENTRY_POINTS = {
    "Model.init": _model_init,
    "Model.init_cache": _init_cache,
    "TPGroup": _tp_group,
    "DecodeEngine": _decode_engine,
    "params_from_jax": _params_from_jax,
    "launch.serve": _launch_serve,
    "init_train_state": _init_train_state,
    "make_pipeline": _make_pipeline,
    "opt_state_from_jax": _opt_state_from_jax,
    "train": _train,
    "launch.train": _launch_train,
    "get_engine(\"torch\")": _torch_engine,
    "fit_machine": _fit_machine,
    "AdaptiveTier": _adaptive_tier,
    "Model.init_cache(enc_len=)": _init_cache_enc_len,
    "DecodeEngine(enc_len=)": _decode_engine_enc_len,
    "launch.serve (encoder-decoder)": _launch_serve_encdec,
    "launch.train (MoE)": _launch_train_moe,
    "Model.init_cache (hybrid)": _init_cache_jamba,
    "launch.serve (SSM)": _launch_serve_xlstm,
    "MixedEngine().evaluate": _mixed_engine,
    "sweep_device_stats": _sweep_device_stats,
    "device_batch": _device_batch,
    "scripts.sweep": _sweep_cli,
    "make_host_mesh": _host_mesh,
    "examples/torch_quickstart": _example("quickstart"),
    "examples/torch_explore_design_space": _example("explore_design_space"),
    "examples/torch_serve_batched": _example("serve_batched"),
    "examples/torch_train_tinyllama": _example("train_tinyllama"),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


def test_launch_serve_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "tinyllama-1.1b", "--prompts", "2", "--prompt-len", "3",
          "--new-tokens", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "decoded 4 tokens" in out and "on cpu" in out


def test_import_check_covers_the_schedule_path():
    mods = set(_port_modules())
    for name in ("core.schedule_types", "core.machine", "core.workload",
                 "core.inefficiency", "core.heuristics",
                 "parallel.collectives", "overlap.schedules", "overlap.api",
                 "kernels.ficco_ag_matmul"):
        assert f"repro_torch.{name}" in mods, name


def test_import_check_covers_the_analytic_core():
    mods = set(_port_modules())
    for name in ("core", "core.inefficiency", "core.simulator", "core.engine",
                 "core.batch", "core.explorer"):
        assert f"repro_torch.{name}" in mods, name
    assert "repro_torch.core.linkmodel" not in mods


def test_import_check_covers_the_training_path():
    mods = set(_port_modules())
    for name in ("obs", "obs.trace", "obs.metrics", "tree",
                 "train.optimizer", "train.loop", "data.pipeline",
                 "ckpt.checkpoint", "launch.specs", "launch.train"):
        assert f"repro_torch.{name}" in mods, name


def test_import_check_covers_the_tuner():
    mods = set(_port_modules())
    for name in ("autotune", "autotune.cache", "autotune.tuner", "tune",
                 "tune.variants", "tune.prune", "tune.cost", "tune.search",
                 "tune.registry", "obs.audit", "obs.signature",
                 "obs.timeline"):
        assert f"repro_torch.{name}" in mods, name


def test_import_check_covers_the_grid_engine_sweep_and_learn():
    mods = set(_port_modules())
    for name in ("autotune.torchgrid", "sweep", "sweep.plan", "sweep.synth",
                 "sweep.runner", "learn", "learn.features", "learn.stats",
                 "learn.gate", "learn.fit", "learn.measured", "sweep.device",
                 "scripts", "scripts.sweep", "scripts.merge_sweep"):
        assert f"repro_torch.{name}" in mods, name


def test_import_check_covers_the_moe_path():
    mods = set(_port_modules())
    for name in ("overlap", "overlap.moe", "models.mla", "models.moe",
                 "parallel.collectives"):
        assert f"repro_torch.{name}" in mods, name


def test_import_check_covers_the_serving_tier():
    mods = set(_port_modules())
    for name in ("serve.adapt", "obs.sentinel", "parallel.decode_attn",
                 "serve.engine", "launch.serve"):
        assert f"repro_torch.{name}" in mods, name


def test_import_check_covers_the_encdec_and_moe_training_paths():
    mods = set(_port_modules())
    for name in ("models.model", "models.layers", "models.moe",
                 "launch.specs", "data.pipeline", "serve.engine",
                 "launch.serve", "launch.train", "train.loop", "convert"):
        assert f"repro_torch.{name}" in mods, name


def test_import_check_covers_the_recurrent_families_and_the_counters():
    mods = set(_port_modules())
    for name in ("models.mamba", "models.xlstm", "roofline",
                 "roofline.counters", "roofline.analysis"):
        assert f"repro_torch.{name}" in mods, name


def test_import_check_covers_the_dry_run():
    mods = set(_port_modules())
    for name in ("parallel.sharding", "launch.mesh", "launch.dryrun",
                 "scripts.hillclimb", "train.optimizer"):
        assert f"repro_torch.{name}" in mods, name


def test_import_check_covers_the_command_lines():
    mods = set(_port_modules())
    for name in ("scripts", "scripts.trace", "scripts.obs_merge",
                 "scripts.clear_autotune_cache", "scripts.sweep",
                 "scripts.merge_sweep", "scripts.hillclimb"):
        assert f"repro_torch.{name}" in mods, name


def test_import_check_covers_the_rank_group():
    mods = set(_port_modules())
    for name in ("parallel.group", "kernels.peer_memory",
                 "parallel.collectives", "launch.group",
                 "overlap.rank_schedules"):
        assert f"repro_torch.{name}" in mods, name
