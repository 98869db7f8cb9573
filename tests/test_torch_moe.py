"""The MoE family and latent attention against the reference, on the CPU,
serving and training.

The expert-parallel dispatch (``repro_torch.overlap.moe``) over a group of
4 logical ranks is held against the reference's ``serial_a2a_ffn`` and
``ficco_a2a_ffn`` under ``shard_map`` on 4 forced host devices, which run
in the session's one JAX subprocess (``tests/torch_jax_reference.py``),
at the reference's 1e-5; the variants are bit-identical to each other.
MLA and the MoE FFN are held against the reference's layers in this
process at 1e-5, and the reduced DeepSeek-V2-Lite and Arctic models
(weights carried across by ``params_from_jax``) at the model tolerance
2e-3.  Training (ROADMAP A11): the reduced models' loss and every
gradient leaf against ``jax.value_and_grad`` of the reference's
``model.loss``, and two AdamW steps against its jitted train step (the
subprocess's ``moe_grad`` entry), from one state carried across by
``convert``; the 2D path on 4 ranks against dense; the router fp32 in a
bf16 step; the launcher.  All in fp32 unless said, inputs from numpy
seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_reference as jax_reference

from repro.configs import get_config as jax_get_config
from repro.core.workload import StepProfile as JaxStepProfile
from repro.models import mla as jax_mla
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro.overlap.moe import skewed_chunk_sizes as jax_skewed_chunk_sizes
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.configs.base import OverlapConfig
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core.workload import StepProfile
from repro_torch.kernels import dma_exchange, ops
from repro_torch.models import mla, moe
from repro_torch.models.model import build_model
from repro_torch.overlap import (
    ficco_a2a_ffn,
    serial_a2a_ffn,
    skewed_chunk_sizes,
)
from repro_torch.parallel.collectives import all_to_all
from repro_torch.parallel.sharding import TPGroup, tp_group
from repro_torch.serve.engine import DecodeEngine, Request, make_prefill
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import (
    init_train_state,
    loss_and_grads,
    make_train_step,
)
from repro_torch.tree import leaves
from repro_torch.tune.variants import default_variant

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)  # the reference's layer tolerance
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)  # its model-forward tolerance
DEEPSEEK, ARCTIC = "deepseek-v2-lite-16b", "arctic-480b"


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    """The JAX subprocess runs while the in-process tests run."""
    jax_reference.start(tmp_path_factory)


@pytest.fixture(scope="module")
def dispatch_reference(tmp_path_factory):
    return jax_reference.reference(tmp_path_factory)["moe"]


@pytest.fixture(scope="module")
def grad_reference(tmp_path_factory):
    return jax_reference.reference(tmp_path_factory, entry="moe_grad")


def _t(tree):
    """A reference param tree (jax arrays) as torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _rand(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# The expert-parallel dispatch over 4 logical ranks
# ---------------------------------------------------------------------------

def test_all_to_all_matches_lax_on_every_rank():
    x = _rand(4, 4, 3, 5, seed=1)
    want = jax.vmap(
        lambda v: jax.lax.all_to_all(v, "r", 0, 0), axis_name="r"
    )(jnp.asarray(x))
    got = all_to_all(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        all_to_all(torch.zeros(4, 2, 3))


def _port_case(name: str, x, w_up, w_down):
    g = jax_reference.MOE["g"]
    reverse = dataclasses.replace(
        default_variant("ficco_a2a_ffn", group=g), dispatch_order="reverse")
    kwargs = {
        "default": {},
        "chunks3": {"chunks": 3},
        "reverse": {"variant": reverse},
        "skewed": {"profile": StepProfile.skewed(g, jax_reference.MOE_SKEW)},
        "sizes": {"chunk_sizes": jax_reference.MOE_SIZES},
    }
    if name == "serial":
        return serial_a2a_ffn(x, w_up, w_down)
    return ficco_a2a_ffn(x, w_up, w_down, **kwargs[name])


def _operands():
    return [torch.from_numpy(a) for a in jax_reference.moe_operands()]


def test_a2a_ffn_variants_bit_identical():
    """Every cut and order reassembles the outputs in capacity order; on
    the CPU each expert row's GEMMs do not depend on the cut, so every
    variant equals the serial dispatch bit for bit."""
    ops = _operands()
    want = _port_case("serial", *ops).numpy()
    for name in jax_reference.MOE_CASES[1:]:
        np.testing.assert_array_equal(_port_case(name, *ops).numpy(), want,
                                      err_msg=name)


def test_a2a_ffn_falls_back_as_the_reference():
    """A promoted chunk count that does not divide C falls back to one
    chunk per rank; an explicit one, to the serial dispatch."""
    x, w_up, w_down = _operands()  # C = 12, g = 4
    calls = []
    odd = dataclasses.replace(default_variant("ficco_a2a_ffn", group=4),
                              chunks=5)
    with pytest.MonkeyPatch.context() as mp:
        import repro_torch.overlap.moe as port_moe

        orig = port_moe._exchange_ffn
        mp.setattr(port_moe, "_exchange_ffn",
                   lambda p, *a: calls.append(p.shape[2]) or orig(p, *a))
        ficco_a2a_ffn(x, w_up, w_down, variant=odd)
        assert calls == [3, 3, 3, 3]
        calls.clear()
        ficco_a2a_ffn(x, w_up, w_down, chunks=5)
        assert calls == [12]


@pytest.mark.parametrize("sizes", [(5, -1, 4, 4), (5, 0, 4, 2)])
def test_bad_chunk_sizes_raise(sizes):
    with pytest.raises(ValueError, match="chunk_sizes"):
        ficco_a2a_ffn(*_operands(), chunk_sizes=sizes)


@pytest.mark.parametrize("capacity,skew", [(12, 2.0), (60, 2.0), (37, 3.5)])
def test_skewed_chunk_sizes_match_reference(capacity, skew):
    assert skewed_chunk_sizes(capacity, StepProfile.skewed(4, skew)) == (
        jax_skewed_chunk_sizes(capacity, JaxStepProfile.skewed(4, skew)))


# ---------------------------------------------------------------------------
# The layers: MLA and the MoE FFN
# ---------------------------------------------------------------------------

def _reduced(arch, **moe_changes):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if moe_changes:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes))
    return cfg, jcfg


def _mla_setup():
    cfg, jcfg = _reduced(DEEPSEEK)
    params = jax_mla.mla_init(jax.random.PRNGKey(1), jcfg.d_model,
                              jcfg.num_heads, jcfg.mla, jnp.float32)
    return cfg, jcfg, params


def test_mla_apply_matches_reference():
    cfg, jcfg, params = _mla_setup()
    assert cfg.mla.v_head_dim < cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
    x = _rand(2, 24, cfg.d_model, seed=2)
    positions = np.broadcast_to(np.arange(24), (2, 24))
    want = jax_mla.mla_apply(params, jnp.asarray(x), jcfg.num_heads,
                             jcfg.mla, positions=jnp.asarray(positions))
    got = mla.mla_apply(_t(params), torch.from_numpy(x), cfg.num_heads,
                        cfg.mla, positions=torch.from_numpy(positions.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_mla_decode_matches_reference():
    """Eight steps from an empty latent cache: each step's output and the
    cache after the last (latent and rope key only)."""
    cfg, jcfg, params = _mla_setup()
    x = _rand(2, 8, 1, cfg.d_model, seed=3)
    jcache = jax_mla.mla_init_cache(2, 12, jcfg.mla, jnp.float32)
    cache = mla.mla_init_cache(2, 12, cfg.mla, torch.float32, "cpu")
    tparams = _t(params)
    for pos in range(8):
        want, jcache = jax_mla.mla_decode(
            params, jnp.asarray(x[:, pos]), jcache, pos, jcfg.num_heads,
            jcfg.mla)
        got, cache = mla.mla_decode(tparams, torch.from_numpy(x[:, pos]),
                                    cache, pos, cfg.num_heads, cfg.mla)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL)
    assert sorted(cache) == ["c_kv", "k_rope"]
    for key in cache:
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **LAYER_TOL)


def _dropped(x, router, cfg) -> int:
    """Assignments past capacity, by the reference's rule, in numpy."""
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1).astype(np.float64) @ router
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    counts = np.bincount(top.reshape(-1), minlength=cfg.num_experts)
    capacity = int(max(cfg.capacity_factor * t * cfg.top_k
                       / cfg.num_experts, 4))
    return int(np.maximum(counts - capacity, 0).sum())


@pytest.mark.parametrize("arch,capacity_factor", [
    (DEEPSEEK, 1.25), (DEEPSEEK, 0.5), (ARCTIC, 1.25),
])
def test_moe_apply_matches_reference(arch, capacity_factor):
    """Output and aux loss; at capacity factor 0.5 tokens are dropped."""
    cfg, jcfg = _reduced(arch, capacity_factor=capacity_factor)
    params = jax_moe.moe_init(jax.random.PRNGKey(2), jcfg.d_model, jcfg.moe,
                              jnp.float32)
    x = _rand(2, 16, cfg.d_model, seed=4)
    want, want_aux = jax_moe.moe_apply(params, jnp.asarray(x), jcfg.moe)
    got, aux = moe.moe_apply(_t(params), torch.from_numpy(x), cfg.moe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **LAYER_TOL)
    if capacity_factor < 1:
        assert _dropped(x, np.asarray(params["router"], np.float64),
                        cfg.moe) > 0


# ---------------------------------------------------------------------------
# Whole models, with the reference's weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[DEEPSEEK, ARCTIC])
def model_reference(request):
    cfg, jcfg = _reduced(request.param)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    (loss, parts), (logits, aux) = jax.jit(
        lambda p: (jmodel.loss(p, batch), jmodel.forward(p, batch)))(params)
    return dict(
        cfg=cfg, jcfg=jcfg, jmodel=jmodel, params=params,
        state=params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu"),
        tokens=tokens, logits=np.asarray(logits), aux=float(aux),
        loss=float(loss), ce=float(parts["ce"]),
    )


def test_forward_and_loss_match_reference(model_reference):
    r = model_reference
    model = build_model(r["cfg"])
    tokens = torch.from_numpy(r["tokens"]).long()
    logits, aux = model.forward(r["state"], {"tokens": tokens})
    np.testing.assert_allclose(logits.numpy(), r["logits"], **MODEL_TOL)
    assert aux.item() > 0
    np.testing.assert_allclose(aux.item(), r["aux"], **MODEL_TOL)
    loss, parts = model.loss(r["state"], {"tokens": tokens,
                                          "labels": tokens})
    np.testing.assert_allclose(loss.item(), r["loss"], **MODEL_TOL)
    np.testing.assert_allclose(parts["ce"].item(), r["ce"], **MODEL_TOL)


def test_decode_matches_reference_and_forward(model_reference):
    """Prompts fed through the decode path step by step: each step's
    logits against the reference's ``decode_step``, and all of them
    against the port's forward.  A step's 2 tokens never overflow an
    expert's capacity of 4, while the forward's 32 may: the forward is
    run at the capacity factor E/k, at which no token is dropped either."""
    r = model_reference
    cfg, jmodel = r["cfg"], r["jmodel"]
    model = build_model(cfg)
    steps = 8
    tokens = r["tokens"][:, :steps]
    jcache = jmodel.init_cache(2, 16)
    cache = model.init_cache(2, 16, device="cpu")
    ref_step = jax.jit(jmodel.decode_step)
    outs = []
    for pos in range(steps):
        want, jcache = ref_step(r["params"], jcache, tokens[:, pos:pos + 1],
                                jnp.int32(pos))
        got, cache = model.decode_step(
            r["state"], cache, torch.from_numpy(tokens[:, pos:pos + 1]).long(),
            pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        outs.append(got)
    no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    full, _ = build_model(no_drop).forward(
        r["state"], {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **MODEL_TOL)


def test_decode_engine_matches_reference_tokens(model_reference):
    r = model_reference
    prompts = np.random.default_rng(6).integers(
        0, r["cfg"].vocab_size, (2, 5)).astype(np.int32)
    want = JaxDecodeEngine(r["jcfg"], r["params"], batch_size=2).run(
        [JaxRequest(p, max_new_tokens=3) for p in prompts])
    got = DecodeEngine(r["cfg"], r["state"], batch_size=2,
                       device="cpu").run(
        [Request(p, max_new_tokens=3) for p in prompts])
    assert [q.out for q in got] == [q.out for q in want]


def test_remat_carries_the_aux_loss(model_reference):
    """Under ``remat`` each period is recomputed in the backward, and the
    MoE layers' aux loss comes out of the checkpointed period: the loss,
    its parts and the gradients equal the run without it."""
    r = model_reference
    tokens = torch.from_numpy(r["tokens"]).long()
    batch = {"tokens": tokens, "labels": tokens}
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(r["cfg"], remat=remat)
        state = {k: v for k, v in r["state"].items()}
        leaves = [state["layers"][0]["ffn"]["router"],
                  state["layers"][0]["ffn"]["w_up"]]
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        state["layers"] = [dict(state["layers"][0],
                                ffn=dict(state["layers"][0]["ffn"],
                                         router=leaves[0], w_up=leaves[1]))]
        loss, parts = build_model(cfg).loss(state, batch)
        results.append((loss, parts["aux"],
                        torch.autograd.grad(loss, leaves)))
    (loss0, aux0, g0), (loss1, aux1, g1) = results
    assert aux1.item() > 0
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(aux1, aux0, rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g0):
        assert a.abs().sum() > 0
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_dma_prefill_on_four_ranks_matches_dense(monkeypatch):
    """The shared experts' up and gate projections take the copy-engine
    path on 4 ranks (K3's plain version: 2 layers x 2 projections x 4
    steps); the logits equal the dense forward's."""
    cfg = dataclasses.replace(
        get_config(DEEPSEEK).reduced(),
        overlap=OverlapConfig(mode="ficco_auto", backend="dma"))
    model = build_model(cfg)
    state = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 64))).long()
    exchanges = []
    orig = dma_exchange.a2a_chunk_exchange

    def spy(chunks, **kwargs):
        exchanges.append(chunks.device.type)
        return orig(chunks, **kwargs)

    monkeypatch.setattr(dma_exchange, "a2a_chunk_exchange", spy)
    prefill = make_prefill(model)
    with torch.no_grad():
        dense = prefill(state, {"tokens": tokens})
        assert exchanges == []
        with tp_group(TPGroup(4, "cpu")):
            got = prefill(state, {"tokens": tokens})
    assert exchanges == ["cpu"] * 16
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **LAYER_TOL)


def test_convert_keeps_the_router_fp32():
    """A bf16 config: every leaf comes back in the dtype the reference's
    ``Model.init`` gives it, the router fp32 and the rest bf16, as the
    port's own ``Model.init`` makes them."""
    from repro_torch.tree import named_leaves

    cfg, jcfg = _reduced(DEEPSEEK)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    state = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    want = {path: np.asarray(leaf).dtype.name for path, leaf in
            named_leaves(jax.tree.map(np.asarray, params))}
    got = {path: str(t.dtype).removeprefix("torch.")
           for path, t in named_leaves(state)}
    assert got == want
    assert got["layers/0/ffn/router"] == "float32"
    assert got["layers/0/ffn/w_up"] == "bfloat16"
    own = {path: t.dtype for path, t in
           named_leaves(build_model(cfg).init(0, device="cpu"))}
    assert own == {path: t.dtype for path, t in named_leaves(state)}


@pytest.mark.parametrize("arch", [DEEPSEEK, ARCTIC])
def test_launch_serve_runs_moe_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--prompts", "2", "--prompt-len", "3",
          "--new-tokens", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "decoded 4 tokens" in out and "on cpu" in out


# ---------------------------------------------------------------------------
# Training (ROADMAP A11)
# ---------------------------------------------------------------------------

def _tokens_batch(cfg, seed, shape=(2, 32)):
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape))
    return {"tokens": tokens, "labels": tokens}


def test_2d_train_step_on_four_ranks_matches_dense(monkeypatch):
    """On uniform-fused-2d the shared experts' up and gate projections run
    K2 on 4 ranks (2 layers x 2 projections x 4 steps); the step's metrics
    and new state equal the dense step's at the model tolerance (AdamW's
    normalisation lifts a gradient's last-place difference where the
    gradient is near zero)."""
    base = get_config(DEEPSEEK).reduced()
    cfg_2d = dataclasses.replace(base, overlap=OverlapConfig(
        mode="uniform-fused-2d", backend="collective"))
    folds = []
    orig = ops.matmul_accumulate
    monkeypatch.setattr(ops, "matmul_accumulate",
                        lambda c, x, w: folds.append(1) or orig(c, x, w))
    state = init_train_state(build_model(base), 0, device="cpu")
    batch = _tokens_batch(base, 8)
    ocfg = opt.OptimizerConfig(**jax_reference.OCFG)
    want, want_m = make_train_step(build_model(base), ocfg)(state, batch)
    assert folds == []
    with tp_group(TPGroup(4, "cpu")):
        got, got_m = make_train_step(build_model(cfg_2d), ocfg)(state, batch)
    assert len(folds) == 16
    for k in want_m:
        torch.testing.assert_close(got_m[k], want_m[k], **MODEL_TOL)
    for a, b in zip(leaves(got), leaves(want)):
        torch.testing.assert_close(a, b, **MODEL_TOL)


def test_bf16_step_keeps_the_router_fp32():
    """In a bf16 model the router stays fp32 through a step, with fp32
    moments like every leaf's, and moves; the experts stay bf16."""
    cfg = dataclasses.replace(get_config(DEEPSEEK).reduced(),
                              dtype="bfloat16")
    state = init_train_state(build_model(cfg), 0, device="cpu")
    new, m = make_train_step(build_model(cfg), opt.OptimizerConfig(
        **jax_reference.OCFG))(state, _tokens_batch(cfg, 9))
    ffn, old = new["params"]["layers"][0]["ffn"], state["params"]["layers"][0]
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_up"].dtype == torch.bfloat16
    assert not torch.equal(ffn["router"], old["ffn"]["router"])
    assert {t.dtype for t in leaves(new["opt_state"]["m"])} == {torch.float32}
    assert all(map(np.isfinite, (m["loss"].item(), m["grad_norm"].item())))


def test_accumulated_step_means_the_aux_loss():
    """accum_steps=2 gives the mean of the two microbatches' aux losses,
    losses and gradients, as the reference's scan sums them."""
    cfg = get_config(ARCTIC).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = _tokens_batch(cfg, 10, (4, 16))
    loss, parts, grads = loss_and_grads(model, params, batch, accum_steps=2)
    halves = [loss_and_grads(model, params,
                             {k: v[i:i + 2] for k, v in batch.items()})
              for i in (0, 2)]
    assert parts["aux"].item() > 0
    for got, want in ((loss, sum(h[0] for h in halves) / 2),
                      (parts["aux"], sum(h[1]["aux"] for h in halves) / 2)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for g, g0, g1 in zip(leaves(grads), *(leaves(h[2]) for h in halves)):
        torch.testing.assert_close(g, (g0 + g1) / 2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch,mode", [(DEEPSEEK, "uniform-fused-2d"),
                                       (ARCTIC, "gspmd_serial")])
def test_launch_train_runs_moe_on_cpu(arch, mode, monkeypatch, capsys):
    """The launcher trains the reduced MoE models; ``--overlap-mode
    uniform-fused-2d`` applies inside a caller's ``tp_group``, as for the
    dense family: K2 on the shared experts (2 layers x 2 x 4 steps)."""
    from repro_torch.launch.train import main

    folds = []
    orig = ops.matmul_accumulate
    monkeypatch.setattr(ops, "matmul_accumulate",
                        lambda c, x, w: folds.append(1) or orig(c, x, w))
    with tp_group(TPGroup(4, "cpu")):
        main(["--arch", arch, "--steps", "1", "--seq-len", "16", "--batch",
              "2", "--overlap-mode", mode, "--device", "cpu"])
    assert len(folds) == (16 if mode == "uniform-fused-2d" else 0)
    assert "done: loss" in capsys.readouterr().out


# Last, so the tests above run while the JAX subprocess computes these.
@pytest.mark.parametrize("arch", [DEEPSEEK, ARCTIC])
def test_grad_step_matches_reference(arch, grad_reference):
    """Loss, its parts and every gradient leaf against ``jax.value_and_grad``
    of the reference's loss; the aux loss reaches the router."""
    r = grad_reference[arch]
    cfg = get_config(arch).reduced()
    params = params_from_jax(r["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in r["batches"][0].items()}
    loss, parts, grads = loss_and_grads(build_model(cfg), params, batch)
    for got, want in ((loss, r["loss"]), (parts["ce"], r["ce"]),
                      (parts["aux"], r["aux"])):
        np.testing.assert_allclose(got.item(), want, **MODEL_TOL)
    got = leaves(grads)
    assert len(got) == len(r["grads"])
    for g, w in zip(got, r["grads"]):
        np.testing.assert_allclose(g.numpy(), w, **MODEL_TOL)
    assert grads["layers"][0]["ffn"]["router"].abs().sum() > 0


@pytest.mark.parametrize("arch", [DEEPSEEK, ARCTIC])
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


@pytest.mark.parametrize("name", jax_reference.MOE_CASES)
def test_a2a_ffn_matches_reference_shard_map(name, dispatch_reference):
    got = _port_case(name, *_operands())
    np.testing.assert_allclose(got.numpy(), dispatch_reference[name],
                               **LAYER_TOL)
