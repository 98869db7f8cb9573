"""The encoder-decoder (SeamlessM4T-v2) and VLM (InternVL2) paths against
the reference, on the CPU.

The reduced models (fp32) start from the reference's weights through
``params_from_jax``; the reference's forward, loss, gradients and cached
decode come from the session's one JAX subprocess (its ``encdec`` entry,
``tests/torch_jax_reference.py``), held at the model tolerance 2e-3.  The
stub frontends' inputs (``train_specs``, ``SyntheticLM``'s extras) are
held against the reference's in this process, bit for bit; the DMA path
and the 2D path on 4 logical ranks against the port's dense forward and
gradients.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_jax_reference as jax_reference

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch.specs import train_specs as jax_train_specs
from repro_torch.configs import get_config
from repro_torch.configs.base import OverlapConfig, ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import dma_exchange, ops
from repro_torch.launch.specs import train_specs
from repro_torch.models.model import build_model
from repro_torch.parallel.sharding import TPGroup, tp_group
from repro_torch.serve.engine import make_prefill
from repro_torch.train.loop import loss_and_grads
from repro_torch.tree import leaves, named_leaves

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)  # the reference's layer tolerance
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)  # its model-forward tolerance
SEAMLESS, INTERNVL = jax_reference.ENCDEC["archs"]
ARCHS = (SEAMLESS, INTERNVL)


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    """The JAX subprocess runs while the in-process tests run."""
    jax_reference.start(tmp_path_factory)


@pytest.fixture(scope="module")
def encdec_reference(tmp_path_factory):
    return jax_reference.reference(tmp_path_factory, entry="encdec")


def _shape():
    e = jax_reference.ENCDEC
    return ShapeConfig("t", e["seq"], e["batch"], "train")


def _batch(cfg, step=0):
    """SyntheticLM's batch ``step`` as tensors (the extras fp32)."""
    return {k: torch.from_numpy(v)
            for k, v in SyntheticLM(cfg, _shape()).batch_at(step).items()}


# ---------------------------------------------------------------------------
# The stub frontends' inputs, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [32, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_specs_match_reference(arch, seq):
    """prefix_embeds (VLM) and enc_frames (audio), bf16, before the int32
    tokens and labels, in the reference's order and shapes."""
    got = train_specs(get_config(arch).reduced(),
                      ShapeConfig("t", seq, 2, "train"))
    want = jax_train_specs(jax_get_config(arch).reduced(),
                           JaxShapeConfig("t", seq, 2, "train"))
    assert list(got) == list(want)
    extra = "enc_frames" if arch == SEAMLESS else "prefix_embeds"
    assert list(got)[0] == extra
    for name, spec in got.items():
        assert spec.shape == tuple(want[name].shape), name
        assert str(spec.dtype).removeprefix("torch.") == want[name].dtype.name


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_extras_bit_identical(arch):
    jcfg = jax_get_config(arch).reduced()
    e = jax_reference.ENCDEC
    ref = JaxSyntheticLM(jcfg, JaxShapeConfig("t", e["seq"], e["batch"],
                                              "train"), seed=3)
    port = SyntheticLM(get_config(arch).reduced(), _shape(), seed=3)
    for step in (0, 1):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert list(got) == list(want)
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# The overlapped paths on 4 logical ranks, against the port's dense ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_dma_prefill_on_four_ranks_matches_dense(arch, monkeypatch):
    """Every MLP's up and gate projections take the copy-engine path on 4
    ranks (K3's plain version), the encoder's too: (2 + 2) layers x 2 x 4
    steps for Seamless, 2 x 2 x 4 for InternVL2, whose prefix of patches
    and text run as one sequence; the logits equal dense."""
    cfg = dataclasses.replace(
        get_config(arch).reduced(),
        overlap=OverlapConfig(mode="ficco_auto", backend="dma"))
    model = build_model(cfg)
    state = model.init(0, device="cpu")
    batch = _batch(cfg)
    exchanges = []
    orig = dma_exchange.a2a_chunk_exchange
    monkeypatch.setattr(dma_exchange, "a2a_chunk_exchange",
                        lambda chunks, **kw: exchanges.append(1)
                        or orig(chunks, **kw))
    prefill = make_prefill(model)
    with torch.no_grad():
        dense = prefill(state, batch)
        assert exchanges == []
        with tp_group(TPGroup(4, "cpu")):
            got = prefill(state, batch)
    layers_n = cfg.num_layers + (cfg.encdec.encoder_layers
                                 if cfg.encdec else 0)
    assert len(exchanges) == layers_n * 2 * 4
    assert got.shape == (*batch["tokens"].shape, cfg.vocab_size)
    torch.testing.assert_close(got, dense, **LAYER_TOL)


def test_2d_gradients_with_remat_match_dense(monkeypatch):
    """Seamless's gradients on uniform-fused-2d with ``remat`` (K2's plain
    version on 4 ranks, the encoder's MLPs too) equal the dense ones
    without it; the backward reruns every encoder layer and decoder
    period, so K2 runs twice per forward: 2 x (2 + 2) layers x (up, gate)
    x 4 steps."""
    base = get_config(SEAMLESS).reduced()
    state = build_model(base).init(0, device="cpu")
    batch = _batch(base)
    _, _, want = loss_and_grads(build_model(base), state, batch)
    folds = []
    orig = ops.matmul_accumulate
    monkeypatch.setattr(ops, "matmul_accumulate",
                        lambda c, x, w: folds.append(1) or orig(c, x, w))
    cfg = dataclasses.replace(base, remat=True, overlap=OverlapConfig(
        mode="uniform-fused-2d", backend="collective"))
    with tp_group(TPGroup(4, "cpu")):
        _, _, got = loss_and_grads(build_model(cfg), state, batch)
    assert len(folds) == 2 * 4 * 2 * 4
    for (name, g), w in zip(named_leaves(got), leaves(want)):
        torch.testing.assert_close(g, w, **LAYER_TOL, msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--prompts", "2", "--prompt-len", "3",
          "--new-tokens", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "decoded 4 tokens" in out and "on cpu" in out


# ---------------------------------------------------------------------------
# Against the reference (last: they wait for the JAX subprocess)
# ---------------------------------------------------------------------------

def _setup(arch, r):
    cfg = get_config(arch).reduced()
    state = params_from_jax(r["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    return cfg, build_model(cfg), state, batch


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_maps_every_leaf(arch, encdec_reference):
    """The encoder, its norm, the cross-attentions and the projector are
    leaf for leaf the reference's, and the port's own init makes the same
    tree."""
    r = encdec_reference[arch]
    cfg, model, state, _ = _setup(arch, r)
    want = [(p, v.shape) for p, v in named_leaves(r["params"])]
    assert [(p, tuple(t.shape)) for p, t in named_leaves(state)] == want
    own = model.init(0, device="cpu")
    assert [(p, tuple(t.shape)) for p, t in named_leaves(own)] == want
    paths = {p for p, _ in want}
    if arch == SEAMLESS:
        assert {"encoder/attn/wq", "enc_norm/scale", "layers/0/cross/wk",
                "layers/0/norm_cross/bias"} <= paths
    else:
        assert "frontend_proj" in paths
        assert state["frontend_proj"].shape == (3200, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, encdec_reference):
    r = encdec_reference[arch]
    _, model, state, batch = _setup(arch, r)
    logits, aux = model.forward(state, batch)
    assert logits.shape == (*batch["tokens"].shape, model.config.vocab_size)
    np.testing.assert_allclose(logits.detach().numpy(), r["logits"],
                               **MODEL_TOL)
    assert aux.item() == r["aux"] == 0.0
    loss, parts = model.loss(state, batch)
    np.testing.assert_allclose(loss.item(), r["loss"], **MODEL_TOL)
    np.testing.assert_allclose(parts["ce"].item(), r["ce"], **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_step_matches_reference(arch, encdec_reference):
    """Every gradient leaf against ``jax.value_and_grad`` of the reference's
    loss: the encoder's, the cross-attentions' and the projector's too."""
    r = encdec_reference[arch]
    _, model, state, batch = _setup(arch, r)
    loss, _, grads = loss_and_grads(model, state, batch)
    np.testing.assert_allclose(loss.item(), r["loss"], **MODEL_TOL)
    got = named_leaves(grads)
    assert len(got) == len(r["grads"])
    for (name, g), w in zip(got, r["grads"]):
        np.testing.assert_allclose(g.numpy(), w, **MODEL_TOL, err_msg=name)
        assert g.abs().sum() > 0 or not np.abs(w).sum(), name


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_decode_matches_reference_and_forward(arch, encdec_reference):
    """The decode's first tokens, step by step, against the reference's
    decode and against the port's forward over the same tokens: for
    Seamless with the cross K/V that ``prefill_cross`` puts in the cache
    from the batch's frames, for InternVL2 on text."""
    r = encdec_reference[arch]
    cfg, model, state, batch = _setup(arch, r)
    e = jax_reference.ENCDEC
    tokens = batch["tokens"][:, :e["decode"]].long()
    fwd_batch = {"tokens": tokens}
    enc_len = 0
    if cfg.encdec:
        fwd_batch["enc_frames"] = batch["enc_frames"]
        enc_len = batch["enc_frames"].shape[1]
    cache = model.init_cache(e["batch"], e["cache"], enc_len=enc_len,
                             device="cpu")
    with torch.no_grad():
        if cfg.encdec:
            assert not cache[0]["cross_k"].any()
            cache = model.prefill_cross(state, cache, batch["enc_frames"])
            assert cache[0]["cross_k"].shape == (
                cfg.num_layers, e["batch"], enc_len, cfg.num_kv_heads,
                cfg.resolved_head_dim)
        steps = []
        for pos in range(e["decode"]):
            lg, cache = model.decode_step(state, cache,
                                          tokens[:, pos:pos + 1], pos)
            steps.append(lg)
        decoded = torch.cat(steps, dim=1)
        full, _ = model.forward(state, fwd_batch)
    np.testing.assert_allclose(decoded.numpy(), r["decode"], **MODEL_TOL)
    torch.testing.assert_close(decoded, full, **MODEL_TOL)
