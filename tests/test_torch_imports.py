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
                 "learn.gate", "learn.fit", "learn.measured"):
        assert f"repro_torch.{name}" in mods, name
    assert "repro_torch.sweep.device" not in mods


def test_import_check_covers_the_moe_path():
    mods = set(_port_modules())
    for name in ("overlap", "overlap.moe", "models.mla", "models.moe",
                 "parallel.collectives"):
        assert f"repro_torch.{name}" in mods, name
