"""The hybrid (Jamba) and SSM (xLSTM) families against the reference, on
the CPU.

The Mamba, mLSTM and sLSTM mixers run in fp32 on numpy-seeded weights and
inputs against the reference's functions in this process, at its layer
tolerance 1e-5.  The reduced models (fp32) start from the reference's
weights through ``params_from_jax``; the reference's forward, loss, cached
decode and ``DecodeEngine`` tokens come from the session's one JAX
subprocess (its ``recurrent`` entry, ``tests/torch_jax_reference.py``),
held at the model tolerance 2e-3, and the decode against the port's own
forward at the reference's 5e-3 (``tests/test_smoke_archs.py``).  In
bf16, where the casts matter, the mixers and the reduced xLSTM are held
at the bf16 tolerance 2e-2, and the mLSTM's and sLSTM's fp32 states at
1e-5.  Each ``DecodeEngine.run`` starts from the recurrent layers'
initial state, where the reference's engine carries it over (ROADMAP
R7).
"""

import dataclasses
from typing import Callable, NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_reference as jax_reference

from repro.configs import get_config as jax_get_config
from repro.models import mamba as jax_mamba
from repro.models import xlstm as jax_xlstm
from repro.models.model import layer_pattern as jax_layer_pattern
from repro_torch.configs import get_config
from repro_torch.configs.base import OverlapConfig
from repro_torch.convert import FP32_LEAVES, params_from_jax
from repro_torch.kernels import dma_exchange
from repro_torch.models import mamba, xlstm
from repro_torch.models.model import (
    build_model,
    layer_pattern,
    reset_recurrent,
)
from repro_torch.parallel.sharding import TPGroup, tp_group
from repro_torch.serve.engine import DecodeEngine, Request, make_prefill
from repro_torch.tree import named_leaves

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)  # the reference's layer tolerance
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)  # its model-forward tolerance
DECODE_TOL = dict(rtol=5e-3, atol=5e-3)  # its recurrent decode vs forward
# In bf16, of the largest |value|: the tolerance the card's bf16 kernels
# are held to (chip_smoke.py), and that of an fp32 state fed by products
# JAX promotes to fp32.
BF16_TOL, STATE_TOL = 2e-2, 1e-5
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
JAMBA, XLSTM = jax_reference.RECURRENT["archs"]
ARCHS = (JAMBA, XLSTM)
MIXERS = ("mamba", "mlstm", "slstm")
B, S, DECODE_STEPS = 2, 12, 4


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    """The JAX subprocess runs while the in-process tests run."""
    jax_reference.start(tmp_path_factory)


@pytest.fixture(scope="module")
def recurrent_reference(tmp_path_factory):
    return jax_reference.reference(tmp_path_factory,
                                   entry="recurrent")


# ---------------------------------------------------------------------------
# The mixers, in this process
# ---------------------------------------------------------------------------

class _Mixer(NamedTuple):
    """One mixer in both packages at its reduced config: the port's init
    (a generator -> fp32 params), apply (params, x), init_cache (batch)
    and decode (params, x, cache), and the reference's apply, init_cache
    and decode; d is the model width."""

    init: Callable
    apply: Callable
    init_cache: Callable
    decode: Callable
    jax_apply: Callable
    jax_init_cache: Callable
    jax_decode: Callable
    d: int


def _mixer(name, dtype=torch.float32) -> _Mixer:
    """``dtype``: the model's, which a Mamba layer's conv window takes."""
    if name == "mamba":
        cfg = get_config(JAMBA).reduced()
        mc, d = cfg.hybrid.mamba, cfg.d_model
        return _Mixer(
            lambda g: mamba.mamba_init(g, d, mc, torch.float32, "cpu"),
            lambda p, x: mamba.mamba_apply(p, x, mc),
            lambda b: mamba.mamba_init_cache(b, d, mc, dtype, "cpu"),
            lambda p, x, c: mamba.mamba_decode(p, x, c, mc),
            lambda p, x: jax_mamba.mamba_apply(p, x, mc),
            lambda b: jax_mamba.mamba_init_cache(b, d, mc,
                                                 JAX_DTYPES[dtype]),
            lambda p, x, c: jax_mamba.mamba_decode(p, x, c, mc), d)
    cfg = get_config(XLSTM).reduced()
    xc, d, h = cfg.xlstm, cfg.d_model, cfg.num_heads
    if name == "mlstm":
        return _Mixer(
            lambda g: xlstm.mlstm_init(g, d, h, xc, torch.float32, "cpu"),
            lambda p, x: xlstm.mlstm_apply(p, x, h, xc),
            lambda b: xlstm.mlstm_init_cache(b, d, h, xc, "cpu"),
            lambda p, x, c: xlstm.mlstm_decode(p, x, c, h, xc),
            lambda p, x: jax_xlstm.mlstm_apply(p, x, h, xc),
            lambda b: jax_xlstm.mlstm_init_cache(b, d, h, xc),
            lambda p, x, c: jax_xlstm.mlstm_decode(p, x, c, h, xc), d)
    return _Mixer(
        lambda g: xlstm.slstm_init(g, d, xc, torch.float32, "cpu"),
        lambda p, x: xlstm.slstm_apply(p, x, xc),
        lambda b: xlstm.slstm_init_cache(b, d, xc, "cpu"),
        lambda p, x, c: xlstm.slstm_decode(p, x, c, xc),
        lambda p, x: jax_xlstm.slstm_apply(p, x, xc),
        lambda b: jax_xlstm.slstm_init_cache(b, d, xc),
        lambda p, x, c: jax_xlstm.slstm_decode(p, x, c, xc), d)


# The reference's init scales, where they are not 1/sqrt(rows) (a
# matrix's) or 1 (a vector's): the draws below keep each leaf at its scale.
_SCALES = {"conv_w": 0.1, "r_gates": 0.02, "conv_b": 0.0, "dt_bias": 0.0}


def _setup_mixer(name, dtype=torch.float32):
    """The mixer, its numpy-seeded weights for each package, and a
    numpy-seeded input (B, S, d), in ``dtype`` but for the reference's
    fp32 leaves (:data:`FP32_LEAVES`).  Each leaf is drawn about its scale
    in the reference's init: a matrix normal times its scale, a vector its
    scale plus 0.1 normal; ``a_log`` keeps its init, log(1..N) per
    channel, in both packages."""
    mx = _mixer(name, dtype)
    rng = np.random.default_rng(MIXERS.index(name))
    w = {}
    for key, t in mx.init(torch.Generator().manual_seed(0)).items():
        if key == "a_log":
            w[key] = t.numpy()
        elif t.ndim == 2:
            scale = _SCALES.get(key, 1 / np.sqrt(t.shape[0]))
            w[key] = (scale * rng.standard_normal(t.shape)).astype(
                np.float32)
        else:
            w[key] = (_SCALES.get(key, 1.0) + 0.1 * rng.standard_normal(
                t.shape)).astype(np.float32)
    x = np.random.default_rng(7).standard_normal((B, S, mx.d)).astype(
        np.float32)
    port_w = {k: torch.from_numpy(v.copy()).to(
        torch.float32 if k in FP32_LEAVES else dtype) for k, v in w.items()}
    jax_w = {k: jnp.asarray(v, jnp.float32 if k in FP32_LEAVES
                            else JAX_DTYPES[dtype]) for k, v in w.items()}
    return (mx, port_w, jax_w, torch.from_numpy(x).to(dtype),
            jnp.asarray(x, JAX_DTYPES[dtype]))


@pytest.mark.parametrize("name", MIXERS)
def test_mixer_apply_matches_reference(name):
    mx, port_w, jax_w, x, jx = _setup_mixer(name)
    got = mx.apply(port_w, x)
    want = np.asarray(mx.jax_apply(jax_w, jx))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


@pytest.mark.parametrize("name", MIXERS)
def test_mixer_decode_matches_reference(name):
    """Step by step from the initial state: each step's output and the
    state after the last against the reference's decode."""
    mx, port_w, jax_w, x, jx = _setup_mixer(name)
    cache, jax_cache = mx.init_cache(B), mx.jax_init_cache(B)
    for t in range(DECODE_STEPS):
        got, cache = mx.decode(port_w, x[:, t:t + 1], cache)
        want, jax_cache = mx.jax_decode(jax_w, jx[:, t:t + 1], jax_cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL, err_msg=f"step {t}")
    assert sorted(cache) == sorted(jax_cache)
    for key, leaf in cache.items():
        assert leaf.dtype == torch.float32, key
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jax_cache[key]),
                                   **LAYER_TOL, err_msg=key)


def _assert_near(got, want, tol, what):
    """max |got - want| within ``tol`` of the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("name", MIXERS)
def test_mixer_bf16_matches_reference(name):
    """In a bf16 model, where the casts matter: apply's output and each
    decode step's against the reference's at the bf16 tolerance, and the
    mLSTM's and sLSTM's fp32 states after the last step at 1e-5 of their
    largest value.  A product taken in bf16 where JAX promotes to fp32
    (``u @ w_if``, ``u @ w_gates``), or ``k / sqrt(hd)`` or the outer
    product ``k v^T`` taken out of the model dtype, moves those states by
    2e-3 or more.  Mamba's state follows ``silu(u)`` in bf16, which XLA
    on the CPU rounds otherwise than torch's silu (in 4 of 10 elements),
    so it is held at the bf16 tolerance."""
    mx, port_w, jax_w, x, jx = _setup_mixer(name, torch.bfloat16)
    got = mx.apply(port_w, x)
    assert got.dtype == torch.bfloat16
    _assert_near(got.float(), mx.jax_apply(jax_w, jx), BF16_TOL, "apply")
    cache, jax_cache = mx.init_cache(B), mx.jax_init_cache(B)
    for t in range(DECODE_STEPS):
        got, cache = mx.decode(port_w, x[:, t:t + 1], cache)
        want, jax_cache = mx.jax_decode(jax_w, jx[:, t:t + 1], jax_cache)
        _assert_near(got.float(), want, BF16_TOL, f"step {t}")
    state_tol = BF16_TOL if name == "mamba" else STATE_TOL
    for key, leaf in cache.items():
        _assert_near(leaf.float(), jax_cache[key], state_tol, key)


# ---------------------------------------------------------------------------
# The models' structure and dtypes, in this process
# ---------------------------------------------------------------------------

def _chip_cut(arch):
    """Jamba cut to 4 layers with attention on slot 2, as the card runs
    it; xLSTM whole."""
    cfg = get_config(arch)
    if arch != JAMBA:
        return cfg
    return dataclasses.replace(cfg, num_layers=4, hybrid=dataclasses.replace(
        cfg.hybrid, attn_every=4, attn_offset=2))


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_pattern_matches_reference(arch):
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).reduced(),
                       jax_get_config(arch).reduced())):
        got = [(s.mixer, s.ffn) for s in layer_pattern(cfg)]
        assert got == [(s.mixer, s.ffn) for s in jax_layer_pattern(jcfg)]
    cut = [(s.mixer, s.ffn) for s in layer_pattern(_chip_cut(arch))]
    if arch == JAMBA:
        assert cut == [("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp"),
                       ("mamba", "moe")]
    else:
        assert cut == [("mlstm", "none")] * 7 + [("slstm", "none")]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_init_keeps_the_fp32_leaves(arch):
    """In a bf16 model the reference's fp32 leaves stay fp32 (Mamba's
    ``a_log`` and ``d_skip``, the mLSTM's ``w_if``, the sLSTM's gate
    matrices, the router), in the port's init and through ``convert``;
    every other leaf is bf16, and an xLSTM layer has no ``norm2`` or
    ``ffn``."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    state = build_model(cfg).init(0, device="cpu")
    converted = params_from_jax(_to_numpy(state), cfg, device="cpu")
    want_fp32 = {"a_log", "d_skip", "router"} if arch == JAMBA else {
        "w_if", "w_gates", "r_gates"}
    for tree in (state, converted):
        fp32 = set()
        for path, t in named_leaves(tree):
            leaf = path.rsplit("/", 1)[-1]
            assert t.dtype == (torch.float32 if leaf in FP32_LEAVES
                               else torch.bfloat16), path
            if t.dtype == torch.float32:
                fp32.add(leaf)
        assert fp32 == want_fp32
    paths = {p for p, _ in named_leaves(state)}
    assert any("/ffn/" in p for p in paths) == (arch == JAMBA)
    assert any("/norm2/" in p for p in paths) == (arch == JAMBA)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.float().numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_recurrent_returns_the_cache_to_its_start(arch):
    """After a decode has moved the state, a ``run`` restart leaves every
    recurrent leaf as ``init_cache`` makes it (m at -1e30, the rest 0) and
    every attention leaf as it was."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    state = model.init(0, device="cpu")
    cache = model.init_cache(2, 8, device="cpu")
    fresh = model.init_cache(2, 8, device="cpu")
    with torch.no_grad():
        for pos in range(3):
            _, cache = model.decode_step(
                state, cache, torch.full((2, 1), pos + 1), pos)
    moved = [{k: v.clone() for k, v in c.items()} for c in cache]
    reset_recurrent(model.pattern, cache)
    for spec, got, was, start in zip(model.pattern, cache, moved, fresh):
        for key in got:
            want = (start[key] if spec.mixer in MIXERS else was[key])
            assert torch.equal(got[key], want), (spec, key)
        if spec.mixer in MIXERS:
            assert any(not torch.equal(was[k], start[k]) for k in was)


# ---------------------------------------------------------------------------
# The DMA path on 4 logical ranks, against the port's dense one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_dma_prefill_on_four_ranks_matches_dense(arch, monkeypatch):
    """Jamba's MLP layer takes the copy-engine path (K3's plain version),
    1 layer x (up, gate) x 4 steps; its MoE layer has no shared expert and
    its Mamba and attention mixers no FiCCO site.  xLSTM has none at all:
    no exchange, and logits bit-equal to dense."""
    cfg = dataclasses.replace(
        get_config(arch).reduced(),
        overlap=OverlapConfig(mode="ficco_auto", backend="dma"))
    model = build_model(cfg)
    state = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    exchanges = []
    orig = dma_exchange.a2a_chunk_exchange
    monkeypatch.setattr(dma_exchange, "a2a_chunk_exchange",
                        lambda chunks, **kw: exchanges.append(1)
                        or orig(chunks, **kw))
    prefill = make_prefill(model)
    with torch.no_grad():
        dense = prefill(state, {"tokens": tokens})
        with tp_group(TPGroup(4, "cpu")):
            got = prefill(state, {"tokens": tokens})
    n_mlp = sum(s.ffn == "mlp" for s in model.pattern) * model.n_periods
    assert len(exchanges) == n_mlp * 2 * 4 == (8 if arch == JAMBA else 0)
    if arch == JAMBA:
        torch.testing.assert_close(got, dense, **LAYER_TOL)
    else:
        assert torch.equal(got, dense)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--prompts", "2", "--prompt-len", "3",
          "--new-tokens", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "decoded 4 tokens" in out and "on cpu" in out


def test_attention_engine_runs_unchanged_by_the_restart():
    """TinyLlama has no recurrent state: the restart touches nothing, and
    a second run on one engine gives the first's tokens."""
    cfg = get_config("tinyllama-1.1b").reduced()
    eng = DecodeEngine(cfg, build_model(cfg).init(0, device="cpu"),
                       batch_size=2, cache_len=16, device="cpu")
    runs = [[r.out for r in eng.run(jax_reference.recurrent_requests(
        Request, cfg.vocab_size))] for _ in range(2)]
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# Against the reference (last: they wait for the JAX subprocess)
# ---------------------------------------------------------------------------

def _setup(arch, r):
    cfg = get_config(arch).reduced()
    state = params_from_jax(r["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    return cfg, build_model(cfg), state, batch


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_maps_every_leaf(arch, recurrent_reference):
    """The mixers' leaves under ``mixer``, and no ``norm2`` / ``ffn`` in a
    layer without an FFN: leaf for leaf the reference's tree, and the
    port's own init makes the same tree."""
    r = recurrent_reference[arch]
    _, model, state, _ = _setup(arch, r)
    want = [(p, v.shape) for p, v in named_leaves(r["params"])]
    assert [(p, tuple(t.shape)) for p, t in named_leaves(state)] == want
    own = model.init(0, device="cpu")
    assert [(p, tuple(t.shape)) for p, t in named_leaves(own)] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, recurrent_reference):
    r = recurrent_reference[arch]
    _, model, state, batch = _setup(arch, r)
    with torch.no_grad():
        logits, aux = model.forward(state, batch)
        loss, parts = model.loss(state, batch)
    assert logits.shape == (*batch["tokens"].shape, model.config.vocab_size)
    np.testing.assert_allclose(logits.numpy(), r["logits"], **MODEL_TOL)
    np.testing.assert_allclose(aux.item(), r["aux"], **MODEL_TOL)
    np.testing.assert_allclose(loss.item(), r["loss"], **MODEL_TOL)
    np.testing.assert_allclose(parts["ce"].item(), r["ce"], **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_decode_matches_reference_and_forward(arch,
                                                     recurrent_reference):
    """The batch's first tokens decoded step by step from the recurrent
    caches, against the reference's decode (2e-3) and against the port's
    forward over the same tokens (the reference's 5e-3)."""
    r = recurrent_reference[arch]
    _, model, state, batch = _setup(arch, r)
    e = jax_reference.RECURRENT
    tokens = batch["tokens"][:, :e["decode"]].long()
    cache = model.init_cache(e["batch"], e["cache"], device="cpu")
    with torch.no_grad():
        steps = []
        for pos in range(e["decode"]):
            lg, cache = model.decode_step(state, cache,
                                          tokens[:, pos:pos + 1], pos)
            steps.append(lg)
        decoded = torch.cat(steps, dim=1)
        full, _ = model.forward(state, {"tokens": tokens})
    np.testing.assert_allclose(decoded.numpy(), r["decode"], **MODEL_TOL)
    torch.testing.assert_close(decoded, full, **DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_restarts_each_run(arch, recurrent_reference):
    """R7: a fresh engine's run gives the reference's tokens, and a second
    run on the same engine gives the same again (the reference's own
    second run starts from the first's state and differs)."""
    r = recurrent_reference[arch]
    cfg, _, state, _ = _setup(arch, r)
    e = jax_reference.RECURRENT
    eng = DecodeEngine(cfg, state, batch_size=e["batch"],
                       cache_len=e["cache"], device="cpu")
    runs = [[q.out for q in eng.run(jax_reference.recurrent_requests(
        Request, cfg.vocab_size))] for _ in range(2)]
    first, second = r["engine_runs"]
    assert runs[0] == first
    assert runs[1] == first
    # The reference's second run differs (R7), so the check above would
    # catch a port that carried the state over as the reference does.
    assert second != first


def test_bf16_forward_and_decode_match_reference(recurrent_reference):
    """The reduced xLSTM (an mLSTM and an sLSTM layer) in bf16 on the
    reference's bf16 weights: the forward's logits and the cached decode
    against the reference's, and the decode against the port's own
    forward, at the bf16 tolerance.  Prints each package's decode against
    its forward, of the largest logit."""
    r = recurrent_reference[XLSTM]["bf16"]
    cfg = dataclasses.replace(get_config(XLSTM).reduced(), dtype="bfloat16")
    model = build_model(cfg)
    state = params_from_jax(r["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    n = jax_reference.RECURRENT["decode"]
    tokens = batch["tokens"][:, :n].long()
    cache = model.init_cache(tokens.shape[0], jax_reference.RECURRENT["cache"],
                             device="cpu")
    with torch.no_grad():
        logits, _ = model.forward(state, batch)
        steps = []
        for pos in range(n):
            lg, cache = model.decode_step(state, cache,
                                          tokens[:, pos:pos + 1], pos)
            steps.append(lg)
    assert logits.dtype == torch.bfloat16
    decoded, prefix = torch.cat(steps, 1).float(), logits[:, :n].float()
    _assert_near(logits.float(), r["logits"], BF16_TOL, "forward")
    _assert_near(decoded, r["decode"], BF16_TOL, "decode")
    _assert_near(decoded, prefix, BF16_TOL, "decode vs forward")

    def gap(dec, fwd):
        return np.abs(dec - fwd).max() / np.abs(fwd).max()

    print(f"bf16 decode vs forward, of the largest logit: port "
          f"{gap(decoded.numpy(), prefix.numpy()):.3e}, reference "
          f"{gap(r['decode'], r['logits'][:, :n]):.3e}")
