"""Training the hybrid (Jamba) and SSM (xLSTM) families against the
reference, on the CPU (ROADMAP A13).

The reduced models (fp32) start from the reference's weights through
``params_from_jax``; their loss, its parts and every gradient leaf are held
against ``jax.value_and_grad`` of the reference's ``model.loss``, and two
AdamW steps against its jitted ``make_train_step``, at the model tolerance
2e-3 (the session's one JAX subprocess, its ``recurrent_grad`` entry,
``tests/torch_jax_reference.py``).  The mixers' step functions
differentiate (a float64 ``gradcheck`` over a few chained steps: the
mLSTM's and sLSTM's in-place state updates made autograd raise before);
the sLSTM's floor on ``n`` splits the gradient at a tie as ``jnp.maximum``
does; ``remat`` gives the same gradients bit for bit; Jamba's MLP on the
2D schedule over 4 logical ranks gives dense's gradients; a bf16 step keeps
the fp32 leaves, their gradients and every moment in fp32; the launcher
trains both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_reference as jax_reference

from repro.models import xlstm as jax_xlstm
from repro_torch.configs import get_config
from repro_torch.configs.base import OverlapConfig
from repro_torch.convert import (
    FP32_LEAVES,
    opt_state_from_jax,
    params_from_jax,
)
from repro_torch.kernels import ops
from repro_torch.models import mamba, xlstm
from repro_torch.models.model import build_model
from repro_torch.parallel.sharding import TPGroup, tp_group
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import (
    init_train_state,
    loss_and_grads,
    make_train_step,
)
from repro_torch.tree import leaves, named_leaves

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

MODEL_TOL = dict(rtol=2e-3, atol=2e-3)  # the reference's model tolerance
JAMBA, XLSTM = jax_reference.RECURRENT_TRAIN["archs"]
ARCHS = (JAMBA, XLSTM)


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    """The JAX subprocess runs while the in-process tests run."""
    jax_reference.start(tmp_path_factory)


@pytest.fixture(scope="module")
def grad_reference(tmp_path_factory):
    return jax_reference.reference(tmp_path_factory,
                                   entry="recurrent_grad")


def _tokens_batch(cfg, seed, shape=(2, 16)):
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape))
    return {"tokens": tokens, "labels": tokens}


# ---------------------------------------------------------------------------
# The mixers' step functions under autograd
# ---------------------------------------------------------------------------

B, H, HD, D, N, STEPS = 2, 2, 3, 4, 3, 3


def _f64(rng, *shape, scale=1.0, shift=0.0):
    """A float64 leaf that requires grad: shift + scale * normal."""
    return torch.from_numpy(
        shift + scale * rng.standard_normal(shape)).requires_grad_()


def _mlstm_case(rng):
    """STEPS chained mLSTM steps from a nonzero state: (fn, inputs)."""
    state = [_f64(rng, B, H, HD, HD), _f64(rng, B, H, HD),
             _f64(rng, B, H, scale=0.1)]
    seq = [_f64(rng, STEPS, B, H, HD) for _ in range(3)]
    seq += [_f64(rng, STEPS, B, H), _f64(rng, STEPS, B, H, scale=0.1,
                                         shift=-1.0)]

    def fn(c, n, m, q, k, v, li, lf):
        state = {"c": c, "n": n, "m": m}
        hs = []
        for t in range(STEPS):
            h, state = xlstm._mlstm_step(state, q[t], k[t], v[t], li[t],
                                         lf[t])
            hs.append(h)
        return torch.stack(hs), *state.values()

    return fn, (*state, *seq)


def _slstm_case(rng):
    """STEPS chained sLSTM cells; n starts at 1 so the floor never ties."""
    r_gates = _f64(rng, D, 4 * D, scale=0.3)
    g_in = _f64(rng, STEPS, B, 4 * D)
    c, h, m = _f64(rng, B, D), _f64(rng, B, D), _f64(rng, B, D, scale=0.1)
    n = torch.from_numpy(1.0 + rng.random((B, D))).requires_grad_()

    def fn(r_gates, g_in, c, n, h, m):
        state = {"c": c, "n": n, "h": h, "m": m}
        hs = []
        for t in range(STEPS):
            out, state = xlstm._slstm_cell({"r_gates": r_gates}, g_in[t],
                                           state)
            hs.append(out)
        return torch.stack(hs), *state.values()

    return fn, (r_gates, g_in, c, n, h, m)


def _mamba_case(rng):
    """STEPS chained selective-scan steps."""
    a = _f64(rng, D, N, scale=0.3, shift=-1.0)
    h = _f64(rng, B, D, N)
    dt = torch.from_numpy(0.1 + rng.random((STEPS, B, D))).requires_grad_()
    seq = [_f64(rng, STEPS, B, D), _f64(rng, STEPS, B, N),
           _f64(rng, STEPS, B, N)]

    def fn(h, a, dt, dtu, b_mat, c_mat):
        ys = []
        for t in range(STEPS):
            h, y = mamba._scan_step(h, a, dt[t], dtu[t], b_mat[t], c_mat[t])
            ys.append(y)
        return torch.stack(ys), h

    return fn, (h, a, dt, *seq)


@pytest.mark.parametrize("case", [_mlstm_case, _slstm_case, _mamba_case],
                         ids=["mlstm", "slstm", "mamba"])
def test_step_functions_differentiate(case):
    """Each mixer's step, chained over a few steps, against finite
    differences in float64: each step returns its state out of place, so
    no tensor autograd saved is written by the next."""
    fn, inputs = case(np.random.default_rng(0))
    assert torch.autograd.gradcheck(fn, inputs)


def test_slstm_floor_splits_the_gradient_at_a_tie():
    """n reaches the floor 1e-6 exactly (f = 1, i = 0): the gradient of
    the output with respect to n is the reference's, half of what a
    ``clamp_min`` would pass."""
    d = 3
    pre = np.concatenate([np.full(d, 0.3), np.full(d, -200.0),
                          np.full(d, 100.0), np.full(d, 0.5)])
    w_gates = np.zeros((d, 4 * d), np.float32)
    for blk in range(4):
        w_gates[:, blk * d:(blk + 1) * d] = np.diag(pre[blk * d:(blk + 1) * d])
    u = np.ones((1, d), np.float32)
    state = dict(c=np.ones((1, d), np.float32),
                 n=np.full((1, d), 1e-6, np.float32),
                 h=np.zeros((1, d), np.float32),
                 m=np.zeros((1, d), np.float32))
    r_gates = np.zeros((d, 4 * d), np.float32)

    def jax_out(n):
        params = {"w_gates": jnp.asarray(w_gates),
                  "r_gates": jnp.asarray(r_gates)}
        st = (state["c"], n, state["h"], state["m"])
        return jax_xlstm._slstm_cell(params, jnp.asarray(u), st)[1].sum()

    want = np.asarray(jax.grad(jax_out)(jnp.asarray(state["n"])))
    n = torch.from_numpy(state["n"].copy()).requires_grad_()
    port = {k: torch.from_numpy(v) for k, v in state.items() if k != "n"}
    h, new = xlstm._slstm_cell(
        {"r_gates": torch.from_numpy(r_gates)},
        torch.from_numpy(u) @ torch.from_numpy(w_gates), {**port, "n": n})
    assert torch.equal(new["n"], n.detach())  # the tie
    (got,) = torch.autograd.grad(h.sum(), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    clamped = torch.sigmoid(torch.tensor(0.5)) * -1.0 / 1e-6 ** 2
    np.testing.assert_allclose(got.numpy(), clamped.item() / 2, rtol=1e-6)


# ---------------------------------------------------------------------------
# The reduced models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bit_equal(arch):
    """Each period recomputed in the backward rebuilds its recurrent state
    from zero: the gradients equal the stored forward's bit for bit."""
    cfg = get_config(arch).reduced()
    params = build_model(cfg).init(0, device="cpu")
    batch = _tokens_batch(cfg, 3)
    want = loss_and_grads(build_model(cfg), params, batch)
    got = loss_and_grads(build_model(dataclasses.replace(cfg, remat=True)),
                         params, batch)
    assert torch.equal(got[0], want[0])
    for (name, g), w in zip(named_leaves(got[2]), leaves(want[2])):
        assert torch.equal(g, w), name


def test_2d_grads_on_four_ranks_match_dense(monkeypatch):
    """Jamba's MLP layer on uniform-fused-2d over 4 ranks runs K2 (1 layer
    x 2 projections x 4 steps); its loss and every gradient leaf equal
    dense's at the model tolerance."""
    base = get_config(JAMBA).reduced()
    cfg_2d = dataclasses.replace(base, overlap=OverlapConfig(
        mode="uniform-fused-2d", backend="collective"))
    folds = []
    orig = ops.matmul_accumulate
    monkeypatch.setattr(ops, "matmul_accumulate",
                        lambda c, x, w: folds.append(1) or orig(c, x, w))
    params = build_model(base).init(0, device="cpu")
    batch = _tokens_batch(base, 4)
    want = loss_and_grads(build_model(base), params, batch)
    assert folds == []
    with tp_group(TPGroup(4, "cpu")):
        got = loss_and_grads(build_model(cfg_2d), params, batch)
    assert len(folds) == 8
    torch.testing.assert_close(got[0], want[0], **MODEL_TOL)
    for (name, g), w in zip(named_leaves(got[2]), leaves(want[2])):
        torch.testing.assert_close(g, w, **MODEL_TOL, msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_keeps_the_fp32_leaves(arch):
    """In a bf16 model each gradient leaf takes its parameter's dtype (the
    fp32 leaves' fp32), every moment is fp32, and the fp32 leaves move."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    model = build_model(cfg)
    state = init_train_state(model, 0, device="cpu")
    batch = _tokens_batch(cfg, 5)
    _, _, grads = loss_and_grads(model, state["params"], batch)
    fp32 = 0
    for (name, p), g in zip(named_leaves(state["params"]), leaves(grads)):
        want = (torch.float32 if name.rsplit("/", 1)[-1] in FP32_LEAVES
                else torch.bfloat16)
        assert p.dtype == g.dtype == want, name
        fp32 += want == torch.float32
    assert fp32 == 3  # a_log, d_skip and the router / w_if, w_gates, r_gates
    new, m = make_train_step(model, opt.OptimizerConfig(
        **jax_reference.OCFG))(state, batch)
    assert {t.dtype for t in leaves(new["opt_state"]["m"])} == {torch.float32}
    assert {t.dtype for t in leaves(new["opt_state"]["v"])} == {torch.float32}
    for (name, p), old in zip(named_leaves(new["params"]),
                              leaves(state["params"])):
        if name.rsplit("/", 1)[-1] in FP32_LEAVES:
            assert p.dtype == torch.float32 and not torch.equal(p, old), name
    assert all(map(np.isfinite, (m["loss"].item(), m["grad_norm"].item())))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_on_cpu(arch, capsys):
    from repro_torch.launch.train import main

    main(["--arch", arch, "--steps", "2", "--seq-len", "16", "--batch", "2",
          "--device", "cpu"])
    assert "done: loss" in capsys.readouterr().out


# Last, so the tests above run while the JAX subprocess computes these.
@pytest.mark.parametrize("arch", ARCHS)
def test_grad_step_matches_reference(arch, grad_reference):
    """Loss, its parts and every gradient leaf against
    ``jax.value_and_grad`` of the reference's loss on ``SyntheticLM``'s
    batch 0."""
    r = grad_reference[arch]
    cfg = get_config(arch).reduced()
    params = params_from_jax(r["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in r["batches"][0].items()}
    loss, parts, grads = loss_and_grads(build_model(cfg), params, batch)
    for got, want in ((loss, r["loss"]), (parts["ce"], r["ce"]),
                      (parts["aux"], r["aux"])):
        np.testing.assert_allclose(got.item(), want, **MODEL_TOL)
    got = named_leaves(grads)
    assert len(got) == len(r["grads"])
    for (name, g), w in zip(got, r["grads"]):
        assert g.abs().max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, **MODEL_TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, grad_reference):
    """Two AdamW steps of ``make_train_step`` against the reference's
    jitted step, both from its initial state (``convert``): each step's
    metrics and every leaf of the last state."""
    r = grad_reference[arch]
    cfg = get_config(arch).reduced()
    zeros = jax.tree.map(np.zeros_like, r["params"])  # init_train_state's
    state = {"params": params_from_jax(r["params"], cfg, device="cpu"),
             "opt_state": opt_state_from_jax(
                 {"m": zeros, "v": zeros, "step": np.int32(0)}, cfg,
                 device="cpu")}
    step = make_train_step(build_model(cfg),
                           opt.OptimizerConfig(**jax_reference.OCFG))
    for b, want in zip(r["batches"], r["metrics"]):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "ce", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), want[k], **MODEL_TOL,
                                       err_msg=k)
    want = jax.tree.leaves(r["state"])
    got = leaves(state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **MODEL_TOL)
