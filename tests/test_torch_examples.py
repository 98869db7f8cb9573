"""The port's four examples (``examples/torch_*.py``) on the CPU, each run
whole through its ``main`` in process, against the reference's examples.

``quickstart.py`` and ``explore_design_space.py`` of the reference import
``repro.core`` only up to the lines compared here, so they run in this
process: the quickstart's decision and ranking lines (its source up to
the ``shard_map`` part, run as it stands), the design-space script
whole.  ``serve_batched.py`` imports JAX: its params and tokens come from
the shared JAX subprocess (``tests/torch_jax_reference.py``, entry
``examples``).
"""

import argparse
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_jax_reference as jax_reference
from repro.core import MACHINES as JMACHINES
from repro.core import SCENARIOS as JSCENARIOS
from repro.core import explore_grid as jexplore_grid
from repro.core import select_schedule as jselect_schedule
from repro_torch.autotune import reset_tuner
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    """The JAX subprocess runs while the in-process tests run."""
    jax_reference.start(tmp_path_factory)


@pytest.fixture(autouse=True)
def _fresh_tuner():
    reset_tuner()
    yield
    reset_tuner()


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def _reference_quickstart_lines(machine: str, capsys) -> list[str]:
    """The reference quickstart's steps 1-3, its own source lines, run on
    ``repro.core`` with the ``"numpy"`` engine."""
    src = (ROOT / "examples" / "quickstart.py").read_text()
    part = src[src.index('scenario = SCENARIOS["g9"]'):src.index("# --- 4:")]
    ns = {"SCENARIOS": JSCENARIOS, "select_schedule": jselect_schedule,
          "explore_grid": jexplore_grid, "np": np,
          "machine": JMACHINES[machine],
          "args": argparse.Namespace(backend="numpy", machine=machine,
                                     schedule="auto")}
    capsys.readouterr()
    exec(compile(part, "examples/quickstart.py", "exec"), ns)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("machine", sorted(JMACHINES))
def test_quickstart_matches_reference(machine, capsys):
    want = _reference_quickstart_lines(machine, capsys)
    out = _example("quickstart").main(["--machine", machine, "--device",
                                       "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:-1] == want
    assert any(" <- heuristic" in line for line in want)
    assert lines[-1] == ("ficco_linear(auto) == serial oracle: OK  "
                         "(out (512, 256))")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 256)).astype(np.float32)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    np.testing.assert_allclose(out.numpy(), x @ w, rtol=1e-3, atol=1e-3)


def test_quickstart_autotune_on_the_h100_model(capsys, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE_DIR", str(tmp_path))
    _example("quickstart").main(["--machine", "h100-sxm-8", "--schedule",
                                 "autotune", "--backend", "torch",
                                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ranking on h100-sxm-8 via the torch engine:" in out
    assert out.endswith("ficco_linear(autotune) == serial oracle: OK  "
                        "(out (512, 256))\n")
    assert (tmp_path / "autotune-torch-v2.json").exists()


# ---------------------------------------------------------------------------
# explore_design_space
# ---------------------------------------------------------------------------


def _untimed(text: str) -> list[str]:
    return re.sub(r" in \d+ ms =====", " in <t> ms =====", text).splitlines()


def test_explore_design_space_matches_reference(capsys, monkeypatch):
    """Line for line on ``"numpy"``, the batched grid on the reference's
    eight machines (the first eight of the port's ``machine_grid()``)."""
    import runpy

    monkeypatch.setattr("sys.argv", ["explore_design_space.py",
                                     "--backend", "numpy"])
    capsys.readouterr()
    runpy.run_path(str(ROOT / "examples" / "explore_design_space.py"))
    want = _untimed(capsys.readouterr().out)
    mod = _example("explore_design_space")
    full = mod.machine_grid
    monkeypatch.setattr(mod, "machine_grid", lambda: full()[:8])
    ex = mod.main(["--backend", "numpy", "--device", "cpu"])
    got = _untimed(capsys.readouterr().out)
    assert got == want
    assert "720 scenarios x 8 machines" in "\n".join(got)
    assert ex.grid.total.shape[1:] == (720, 8)


def test_explore_design_space_torch_engine_on_the_cpu(capsys):
    """The ``"torch"`` engine on ``--device cpu`` prints the rankings the
    ``"numpy"`` engine prints, on all of the port's machines."""
    mod = _example("explore_design_space")
    runs = {}
    for backend in ("numpy", "torch"):
        mod.main(["--backend", backend, "--device", "cpu"])
        runs[backend] = [line.replace(f"({backend})", "()")
                         for line in _untimed(capsys.readouterr().out)]
    assert runs["torch"] == runs["numpy"]
    assert "x 12 machines" in "\n".join(runs["torch"])


# ---------------------------------------------------------------------------
# serve_batched and train_tinyllama
# ---------------------------------------------------------------------------


def test_serve_batched_runs_on_the_cpu(capsys):
    out = _example("serve_batched").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert [len(r.out) for r in out] == [12] * 4
    assert text.endswith("OK\n") and "48 tokens in" in text


def test_train_tinyllama_runs_whole(capsys):
    """200 steps, the loss down by more than 0.5, the checkpoint of the
    last step restored, two requests decoded: the example's own
    assertions."""
    res = _example("train_tinyllama").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "restored checkpoint at step 199" in text
    assert text.endswith("OK\n")
    assert res["history"][-1]["step"] == 199


def test_serve_batched_tokens_match_reference(tmp_path_factory, capsys):
    """The reference example's ``PRNGKey(0)`` params through
    ``convert.params_from_jax``: the same 48 tokens."""
    ref = jax_reference.reference(tmp_path_factory,
                                  entry="examples")["serve_batched"]
    cfg = get_config("xlstm-1.3b").reduced()
    mod = _example("serve_batched")
    out = mod.serve(cfg, params_from_jax(ref["params"], cfg, device="cpu"),
                    torch.device("cpu"))
    assert [r.out for r in out] == ref["tokens"]
    assert capsys.readouterr().out.endswith("OK\n")
