"""The training slice vs the reference: the optimizer, the synthetic data,
the loss, whole train steps (dense, and on the 2D schedule over 4 logical
ranks), gradient accumulation, the gradients through K2, the kernels that
refuse to be differentiated, checkpoints in both directions, and the
launcher.

The reference runs at the reduced TinyLlama config (fp32) and the
substrate tests' shape (seq 32 x batch 4); its jitted train step is built
once per module.  The port starts from the same state through
``params_from_jax`` and ``opt_state_from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_reference as jax_reference

from repro.ckpt.checkpoint import restore_checkpoint as jax_restore
from repro.ckpt.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models.model import build_model as jax_build_model
from repro.train import optimizer as jax_opt
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.ckpt.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_config
from repro_torch.configs.base import OverlapConfig, ShapeConfig
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import SyntheticLM, make_pipeline, to_device
from repro_torch.kernels import ops
from repro_torch.launch.specs import train_specs
from repro_torch.models.model import build_model
from repro_torch.obs import metrics, trace
from repro_torch.overlap.schedules import ficco_uniform_fused_2d
from repro_torch.parallel.context import overlap_context
from repro_torch.parallel.collectives import all_gather
from repro_torch.parallel.sharding import TPGroup, shard_columns, tp_group
from repro_torch.parallel.tp import tp_ficco_linear
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import (
    init_train_state,
    loss_and_grads,
    make_train_step,
    train,
)
from repro_torch.tree import leaves, named_leaves, treedef_str

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
# The reference's tolerance for a model forward, fp32 (as in
# tests/test_torch_model.py).
TOL = dict(rtol=2e-3, atol=2e-3)
OCFG = jax_reference.TRAIN["ocfg"]


@pytest.fixture(autouse=True)
def _fresh_obs():
    trace._TRACER = None
    metrics.reset_metrics()
    yield
    trace._TRACER = None
    metrics.reset_metrics()


@pytest.fixture(scope="module")
def reference():
    """The reference's state and its jitted train step run for 2 steps."""
    return jax_reference.train_reference()


def _port_cfg(**overlap):
    cfg = get_config(ARCH).reduced()
    if overlap:
        cfg = dataclasses.replace(cfg, overlap=OverlapConfig(**overlap))
    return cfg


def _port_state(reference, cfg):
    return {
        "params": params_from_jax(reference["state"]["params"], cfg,
                                  device="cpu"),
        "opt_state": opt_state_from_jax(reference["state"]["opt_state"], cfg,
                                        device="cpu"),
    }


def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---- optimizer ------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 10, 100])
def test_lr_at_matches_reference(step):
    kw = dict(peak_lr=1.0, min_lr=0.1, warmup_steps=10, decay_steps=100)
    got = opt.lr_at(opt.OptimizerConfig(**kw), torch.tensor(step,
                                                            dtype=torch.int32))
    want = jax_opt.lr_at(jax_opt.OptimizerConfig(**kw), jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_apply_updates_matches_reference():
    rng = np.random.default_rng(0)
    tree = lambda: {  # noqa: E731
        "b": rng.standard_normal((5,)).astype(np.float32),
        "a": [{"w": rng.standard_normal((4, 3)).astype(np.float32)}],
    }
    params, grads, m, v = tree(), tree(), tree(), tree()
    v = jax.tree.map(np.abs, v)
    ocfg = dict(peak_lr=1e-2, warmup_steps=3, decay_steps=20, grad_clip=0.5)
    state = {"m": m, "v": v, "step": np.int32(4)}
    jp, js, jm = jax_opt.apply_updates(
        params, grads, jax.tree.map(jnp.asarray, state),
        jax_opt.OptimizerConfig(**ocfg),
    )
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    pp, ps, pm = opt.apply_updates(
        jax.tree.map(t, params), jax.tree.map(t, grads),
        {"m": jax.tree.map(t, m), "v": jax.tree.map(t, v),
         "step": torch.tensor(4, dtype=torch.int32)},
        opt.OptimizerConfig(**ocfg),
    )
    assert ps["step"].dtype == torch.int32 and int(ps["step"]) == 5
    for got, want in zip(leaves([pp, ps["m"], ps["v"]]),
                         jax.tree.leaves([jp, js["m"], js["v"]])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-6)


def test_init_state_moment_dtype():
    params = {"w": torch.ones(2, 3, dtype=torch.bfloat16)}
    st = opt.init_state(params, moment_dtype="bfloat16")
    assert st["m"]["w"].dtype == torch.bfloat16
    assert st["step"].shape == () and st["step"].dtype == torch.int32


# ---- data -----------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 2])
def test_synthetic_batches_bit_identical(reference, step):
    shape = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    got = SyntheticLM(_port_cfg(), shape, seed=3).batch_at(step)
    want = JaxSyntheticLM(reference["cfg"], reference["shape"],
                          seed=3).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_prefetches_device_batches():
    shape = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    it = make_pipeline(_port_cfg(), shape, device="cpu")
    b0, b1 = next(it), next(it)
    src = SyntheticLM(_port_cfg(), shape)
    for i, b in enumerate((b0, b1)):
        assert b["tokens"].shape == (4, 32)
        assert b["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      src.batch_at(i)["tokens"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-76b",
                                  "seamless-m4t-large-v2"])
def test_frontend_and_encoder_lengths_match_reference(arch):
    from repro.launch.specs import _frontend_len as jax_frontend_len
    from repro.launch.specs import encoder_len as jax_encoder_len
    from repro_torch.launch.specs import _frontend_len, encoder_len

    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shape = ShapeConfig("t", 4096, 2, "train")
    jshape = JaxShapeConfig("t", 4096, 2, "train")
    assert _frontend_len(cfg, 4096) == jax_frontend_len(jcfg, 4096)
    assert encoder_len(cfg, shape) == jax_encoder_len(jcfg, jshape)


def test_train_specs_refuse_families_not_ported():
    """No family is refused since ROADMAP A13: the hybrid and SSM
    families' specs and ``SyntheticLM`` batches are the reference's."""
    from repro.launch.specs import train_specs as jax_train_specs

    for arch in ("jamba-1.5-large-398b", "xlstm-1.3b"):
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        shape = ShapeConfig("t", 32, 4, "train")
        jshape = JaxShapeConfig("t", 32, 4, "train")
        got, want = train_specs(cfg, shape), jax_train_specs(jcfg, jshape)
        assert list(got) == list(want) == ["tokens", "labels"]
        for name, spec in got.items():
            assert spec.shape == tuple(want[name].shape)
            assert spec.dtype == torch.int32 and want[name].dtype == jnp.int32
        for step in (0, 5):
            b = SyntheticLM(cfg, shape).batch_at(step)
            jb = JaxSyntheticLM(jcfg, jshape).batch_at(step)
            assert list(b) == list(jb)
            for name in b:
                np.testing.assert_array_equal(b[name], jb[name])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_train_specs_of_the_moe_family(arch):
    """The MoE family trains (ROADMAP A11): {tokens, labels}, int32, of
    the reference's shapes."""
    from repro.launch.specs import train_specs as jax_train_specs

    got = train_specs(get_config(arch).reduced(),
                      ShapeConfig("t", 32, 4, "train"))
    want = jax_train_specs(jax_get_config(arch).reduced(),
                           JaxShapeConfig("t", 32, 4, "train"))
    assert list(got) == list(want) == ["tokens", "labels"]
    for name, spec in got.items():
        assert spec.shape == tuple(want[name].shape) == (4, 32)
        assert spec.dtype == torch.int32 and want[name].dtype == jnp.int32


# ---- loss and train steps -------------------------------------------------

def test_loss_matches_reference(reference):
    cfg = _port_cfg()
    loss, parts = build_model(cfg).loss(
        _port_state(reference, cfg)["params"],
        _batch(reference["batches"][0]),
    )
    assert float(parts["aux"]) == 0.0
    np.testing.assert_allclose(loss.item(), reference["loss"], **TOL)
    np.testing.assert_allclose(parts["ce"].item(), reference["ce"], **TOL)


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("path", ["dense", "uniform-fused-2d"])
def test_train_steps_match_reference(reference, path, n_steps, monkeypatch):
    """One and two steps of ``make_train_step`` against the reference's
    jitted dense step: loss, grad_norm and every leaf of the new state.
    On the 2D path the up/gate projections run K2 on 4 logical ranks,
    which computes the same function."""
    cfg = (_port_cfg() if path == "dense"
           else _port_cfg(mode=path, backend="collective"))
    folds = []
    orig = ops.matmul_accumulate

    def spy(c, x, w):
        folds.append(tuple(x.shape))
        return orig(c, x, w)

    monkeypatch.setattr(ops, "matmul_accumulate", spy)
    step = make_train_step(build_model(cfg), opt.OptimizerConfig(**OCFG))
    state = _port_state(reference, cfg)
    with tp_group(TPGroup(4, "cpu")):
        for i in range(n_steps):
            state, m = step(state, _batch(reference["batches"][i]))
    # 2 layers x (up, gate) x 4 K-slice steps per forward.
    assert len(folds) == (16 * n_steps if path != "dense" else 0)
    want_m = reference["metrics"][n_steps - 1]
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), want_m[k], **TOL, err_msg=k)
    want = jax.tree.leaves(reference["states"][n_steps - 1])
    got = leaves(state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_grad_accumulation_equivalence(reference):
    """accum_steps=4 gives the update of the monolithic batch, as
    tests/test_substrate.py holds the reference."""
    cfg = _port_cfg()
    model = build_model(cfg)
    ocfg = opt.OptimizerConfig(**OCFG)
    state = _port_state(reference, cfg)
    batch = _batch(reference["batches"][0])
    s1, m1 = make_train_step(model, ocfg)(state, batch)
    s4, m4 = make_train_step(model, ocfg, accum_steps=4)(state, batch)
    assert abs(m1["loss"].item() - m4["loss"].item()) < 1e-4
    for a, b in zip(leaves(s1["params"]), leaves(s4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_unreached_parameter_gets_zero_gradient(reference):
    cfg = _port_cfg()
    params = dict(_port_state(reference, cfg)["params"])
    params["unused"] = torch.ones(3)
    _, _, grads = loss_and_grads(build_model(cfg), params,
                                 _batch(reference["batches"][0]))
    assert torch.equal(grads["unused"], torch.zeros(3))


# ---- recomputation (remat) ------------------------------------------------

@pytest.fixture(scope="module")
def reference_remat(reference):
    """One step of the reference's jitted step with ``remat=True`` (its
    periods under ``jax.checkpoint``) from the module's state."""
    model = jax_build_model(dataclasses.replace(reference["cfg"], remat=True))
    step = jax.jit(jax_make_train_step(model, jax_opt.OptimizerConfig(**OCFG)))
    state, m = step(jax.tree.map(jnp.asarray, reference["state"]),
                    reference["batches"][0])
    return jax.tree.map(np.asarray, state), {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("path", ["dense", "uniform-fused-2d"])
def test_remat_recomputes_each_period(reference, reference_remat, path,
                                      monkeypatch):
    """With ``remat`` the gradients equal the plain step's under both
    policies, the 2D path runs K2 again in the backward (and only the
    forward's count under ``no_grad``), and the step matches the
    reference's remat step."""
    base = (_port_cfg() if path == "dense"
            else _port_cfg(mode=path, backend="collective"))
    folds = []
    orig = ops.matmul_accumulate

    def spy(c, x, w):
        folds.append(tuple(x.shape))
        return orig(c, x, w)

    monkeypatch.setattr(ops, "matmul_accumulate", spy)
    state = _port_state(reference, base)
    batch = _batch(reference["batches"][0])
    per_forward = 16 if path != "dense" else 0  # 2 layers x 2 x 4 steps
    grads, counts = {}, {}
    with tp_group(TPGroup(4, "cpu")):
        for policy in (None, "nothing", "dots"):
            cfg = (base if policy is None else dataclasses.replace(
                base, remat=True, remat_policy=policy))
            folds.clear()
            _, _, g = loss_and_grads(build_model(cfg), state["params"], batch)
            grads[policy], counts[policy] = leaves(g), len(folds)
        cfg = dataclasses.replace(base, remat=True)
        folds.clear()
        with torch.no_grad(), overlap_context(cfg.overlap):
            build_model(cfg).loss(state["params"], batch)
        assert len(folds) == per_forward
        new, m = make_train_step(build_model(cfg),
                                 opt.OptimizerConfig(**OCFG))(state, batch)
    assert counts == {None: per_forward, "nothing": 2 * per_forward,
                      "dots": 2 * per_forward}
    for policy in ("nothing", "dots"):
        for a, b in zip(grads[policy], grads[None]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    want_state, want_m = reference_remat
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), want_m[k], **TOL, err_msg=k)
    for g, w in zip(leaves(new), jax.tree.leaves(want_state)):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(_port_cfg(), remat=True, remat_policy="offload")
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(cfg)


# ---- gradients through the kernels -----------------------------------------

@pytest.mark.parametrize("g,m_s,k,n", [(4, 8, 16, 24), (2, 5, 6, 4)])
def test_2d_schedule_gradients_match_dense(g, m_s, k, n):
    """K2's autograd Function: the 2D schedule's output has a grad_fn and
    its gradients equal those of the dense all-gather + GEMM (fp32)."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((g, m_s, k)), dtype=torch.float32,
                     requires_grad=True)
    w_full = torch.tensor(rng.standard_normal((k, n * g)),
                          dtype=torch.float32, requires_grad=True)
    w = shard_columns(w_full, g)
    out = ficco_uniform_fused_2d(x, w)
    assert out.grad_fn is not None
    dense = torch.matmul(all_gather(x, tiled=True), w)
    torch.testing.assert_close(out, dense, rtol=1e-5, atol=1e-5)
    d_out = torch.tensor(rng.standard_normal(out.shape), dtype=torch.float32)
    got = torch.autograd.grad(out, (x, w_full), d_out)
    want = torch.autograd.grad(dense, (x, w_full), d_out)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_matmul_accumulate_records_in_place_update():
    """K2's update is in place, recorded for autograd with gradients
    enabled and recorded nowhere under ``no_grad``."""
    c = torch.zeros(3, 4)
    x = torch.randn(3, 5, requires_grad=True)
    w = torch.randn(5, 4)
    out = ops.matmul_accumulate(c, x, w)
    assert out is c and out.grad_fn is not None
    (dx,) = torch.autograd.grad(out.sum(), x)
    torch.testing.assert_close(dx, torch.ones(3, 4) @ w.T)
    c = torch.zeros(3, 4)
    with torch.no_grad():
        out = ops.matmul_accumulate(c, x, w)
    assert out is c and out.grad_fn is None and not out.requires_grad
    torch.testing.assert_close(out, x.detach() @ w)


def _k1(x, w):
    return ops.matmul(x.view(-1, x.shape[-1]), w[0], block_m=4, block_n=4,
                      block_k=8)


def _composer(x, w):
    return ops.ag_matmul_dma(x, w, group=TPGroup(2, "cpu"))


def _fused(x, w):
    return ops.ag_matmul_fused(x, w)


@pytest.mark.parametrize("fn", [_k1, _composer, _fused],
                         ids=["matmul", "ag_matmul_dma", "ag_matmul_fused"])
def test_kernels_without_reverse_rule_refuse_grad(fn):
    x = torch.randn(2, 4, 8)
    w = shard_columns(torch.randn(8, 8), 2)
    with torch.no_grad():
        want = fn(x, w)
    w_full = torch.randn(8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no reverse-mode rule"):
        fn(x, shard_columns(w_full, 2))
    with torch.no_grad():  # inference is unchanged
        assert fn(x, shard_columns(w_full, 2)).shape == want.shape


def test_tp_linear_on_dma_backend_refuses_grad():
    x = torch.randn(2, 8, 8, requires_grad=True)
    w = torch.randn(8, 8)
    with tp_group(TPGroup(2, "cpu")):
        with pytest.raises(RuntimeError, match="no reverse-mode rule"):
            tp_ficco_linear(x, w, OverlapConfig("uniform-fused-1d", "dma"))
        y = tp_ficco_linear(x, w, OverlapConfig("uniform-fused-2d",
                                                "collective"))
    assert y.grad_fn is not None


# ---- checkpoints ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip(tmp_path, dtype):
    cfg = dataclasses.replace(_port_cfg(), dtype=str(dtype).split(".")[1])
    state = init_train_state(build_model(cfg), 0, device="cpu")
    save_checkpoint(str(tmp_path), state, 5)
    assert latest_step(str(tmp_path)) == 5
    restored, step = restore_checkpoint(str(tmp_path), state)
    assert step == 5
    bits = lambda t: (  # noqa: E731
        t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), {"w": torch.zeros(2, 3)}, 1)
    with pytest.raises(ValueError, match="checkpoint shape"):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros(3, 2)})


def test_reference_checkpoint_restores_into_port(reference, tmp_path):
    jax_save(str(tmp_path), reference["states"][0], 7)
    cfg = _port_cfg()
    like = _port_state(reference, cfg)
    restored, step = restore_checkpoint(str(tmp_path), like)
    assert step == 7
    for got, want in zip(leaves(restored),
                         jax.tree.leaves(reference["states"][0])):
        np.testing.assert_array_equal(got.numpy(), want)


def test_reference_bf16_checkpoint_restores_bit_exact(tmp_path):
    """The reference writes ml_dtypes' bfloat16, which numpy reads back as
    2-byte void records: the port takes them as the raw words."""
    w = jnp.asarray(np.random.default_rng(2).standard_normal((3, 4)),
                    jnp.bfloat16)
    jax_save(str(tmp_path), {"w": w}, 1)
    restored, _ = restore_checkpoint(
        str(tmp_path), {"w": torch.zeros(3, 4, dtype=torch.bfloat16)})
    np.testing.assert_array_equal(restored["w"].view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))


def test_port_bf16_checkpoint_is_refused_by_reference(tmp_path):
    """A bf16 leaf is stored as 2-byte void records, the reference's own
    on-disk form: the port restores it bit-exact, and the reference's
    numeric cast refuses it instead of reading the words as integers
    (bf16 1.5 as int16 would come back as 16320)."""
    w = torch.tensor([[1.5, -2.25], [3.0e-3, 7.0]], dtype=torch.bfloat16)
    save_checkpoint(str(tmp_path), {"w": w}, 1)
    with np.load(tmp_path / "ckpt_00000001.npz") as data:
        assert data["leaf_0"].dtype == np.dtype("V2")
    restored, _ = restore_checkpoint(
        str(tmp_path), {"w": torch.zeros(2, 2, dtype=torch.bfloat16)})
    assert torch.equal(restored["w"].view(torch.int16), w.view(torch.int16))
    with pytest.raises(ValueError, match="No cast function"):
        jax_restore(str(tmp_path), {"w": jnp.zeros((2, 2), jnp.bfloat16)})


def test_port_checkpoint_restores_into_reference(reference, tmp_path):
    cfg = _port_cfg()
    state = _port_state(reference, cfg)
    save_checkpoint(str(tmp_path), state, 3)
    like = jax.tree.map(jnp.asarray, reference["state"])
    restored, step = jax_restore(str(tmp_path), like)
    assert step == 3
    for got, want in zip(jax.tree.leaves(restored), leaves(state)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    assert treedef_str(state) == str(jax.tree.structure(like))


def test_named_leaves_follow_reference_paths(reference):
    state = _port_state(reference, _port_cfg())
    want = jax.tree_util.tree_flatten_with_path(reference["state"])[0]
    got = named_leaves(state)
    assert [p for p, _ in got] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in want
    ]
    assert all(a is b for (_, a), b in zip(got, leaves(state)))


# ---- the loop and the launcher --------------------------------------------

def test_train_loop_counts_steps_spans_and_checkpoints(tmp_path):
    tracer = trace.enable()
    logs = []
    res = train(_port_cfg(), ShapeConfig("t", 16, 2, "train"), steps=3,
                log_every=2, checkpoint_dir=str(tmp_path),
                checkpoint_every=2, log_fn=logs.append, device="cpu")
    spans = [e for e in tracer.events if e["name"] == "train/step"]
    assert [e["args"]["step"] for e in spans] == [0, 1, 2]
    assert metrics.get_metrics().counter("train/steps").value == 3
    assert [h["step"] for h in res["history"]] == [0, 2] and len(logs) == 2
    assert latest_step(str(tmp_path)) == 1
    assert int(res["state"]["opt_state"]["step"]) == 3


def test_launch_train_runs_on_cpu(capsys):
    from repro_torch.launch.train import main

    main(["--arch", ARCH, "--steps", "2", "--seq-len", "16", "--batch", "2",
          "--device", "cpu"])
    assert "done: loss" in capsys.readouterr().out


def test_to_device_keeps_dtypes():
    b = to_device({"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)},
                  "cpu")
    assert b["tokens"].dtype == torch.int32
