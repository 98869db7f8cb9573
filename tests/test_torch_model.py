"""The whole slice vs the reference: a reduced TinyLlama forward (dense,
through the DMA-path TP MLP and through ``ficco_linear``'s schedules on 4
logical ranks) and greedy decoding.

The reference's ``Model.init(PRNGKey(0))`` params go to the port through
``repro_torch.convert.params_from_jax``; tokens come from numpy.  With
tokens (2, 512) on 4 ranks the step GEMM is (256, 256) @ (256, 128), so the
K1 branch of the composer is taken (fewer than 256 step rows would not).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.configs.base import OverlapConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import dma_exchange
from repro_torch.models.model import build_model
from repro_torch.parallel.sharding import TPGroup, tp_group
from repro_torch.serve.engine import DecodeEngine, Request, make_prefill

# The reference's own tolerance for the DMA backend inside a model
# (tests/multidev_driver.py::pallas_dma_backend_in_model), fp32 weights.
TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def reference():
    cfg = jax_get_config(ARCH).reduced()
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 512)
    ).astype(np.int32)
    logits, _ = jax.jit(model.forward)(params, {"tokens": tokens})
    return dict(
        cfg=cfg,
        params=params,
        numpy_params=jax.tree.map(np.asarray, params),
        tokens=tokens,
        logits=np.asarray(logits, np.float32),
    )


def _port(reference, **overlap):
    cfg = get_config(ARCH).reduced()
    if overlap:
        cfg = dataclasses.replace(cfg, overlap=OverlapConfig(**overlap))
    state = params_from_jax(reference["numpy_params"], cfg, device="cpu")
    return cfg, build_model(cfg), state


def test_reduced_config_matches_reference(reference):
    cfg = get_config(ARCH).reduced()
    ref_cfg = reference["cfg"]
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "resolved_head_dim", "dtype", "norm",
              "rope_theta", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(ref_cfg, f), f


def test_dense_forward_matches_reference(reference):
    _, model, state = _port(reference)
    logits, _ = model.forward(
        state, {"tokens": torch.from_numpy(reference["tokens"]).long()}
    )
    np.testing.assert_allclose(logits.numpy(), reference["logits"], **TOL)


def test_dma_prefill_on_four_ranks_matches_reference(reference, monkeypatch):
    cfg, model, state = _port(
        reference, mode="uniform-fused-1d", backend="dma"
    )
    # Count the composer's blocked step GEMMs (the K1 branch).
    blocked = []
    orig = dma_exchange.chunked_matmul

    def spy(*args, **kwargs):
        blocked.append(args[0].shape)
        return orig(*args, **kwargs)

    monkeypatch.setattr(dma_exchange, "chunked_matmul", spy)
    with tp_group(TPGroup(4, "cpu")):
        logits = make_prefill(model)(
            state, {"tokens": torch.from_numpy(reference["tokens"]).long()}
        )
    # 2 layers x (up, gate) x 4 steps, each step GEMM (4 ranks, 256 rows)
    assert blocked == [(4, 256, 256)] * 16
    np.testing.assert_allclose(logits.numpy(), reference["logits"], **TOL)


@pytest.mark.parametrize(
    "mode", ["uniform-fused-2d", "hetero-fused-1d", "shard_p2p", "ficco_auto"]
)
def test_collective_prefill_on_four_ranks_matches_reference(
    reference, mode, monkeypatch
):
    """The up/gate projections go through ficco_linear's schedules; K2
    folds every step of the 2D schedule."""
    from repro_torch.kernels import ops

    cfg, model, state = _port(reference, mode=mode, backend="collective")
    folds = []
    orig = ops.matmul_accumulate

    def spy(c, x, w):
        folds.append(tuple(x.shape))
        return orig(c, x, w)

    monkeypatch.setattr(ops, "matmul_accumulate", spy)
    with tp_group(TPGroup(4, "cpu")):
        logits = make_prefill(model)(
            state, {"tokens": torch.from_numpy(reference["tokens"]).long()}
        )
    # 2 layers x (up, gate) x 4 K-slice steps of a (1024, d/4) panel.
    want_folds = (
        [(4, 1024, cfg.d_model // 4)] * 16 if mode == "uniform-fused-2d"
        else []
    )
    assert folds == want_folds
    np.testing.assert_allclose(logits.numpy(), reference["logits"], **TOL)


def test_decode_engine_matches_reference_tokens(reference):
    prompts = np.random.default_rng(4).integers(
        0, reference["cfg"].vocab_size, (2, 6)
    ).astype(np.int32)
    jax_eng = JaxDecodeEngine(reference["cfg"], reference["params"],
                              batch_size=2)
    want = jax_eng.run([JaxRequest(p, max_new_tokens=4) for p in prompts])
    cfg, _, state = _port(reference)
    eng = DecodeEngine(cfg, state, batch_size=2, device="cpu")
    got = eng.run([Request(p, max_new_tokens=4) for p in prompts])
    assert [r.out for r in got] == [r.out for r in want]
    assert all(len(r.out) == 4 and r.done for r in got)


def test_decode_engine_zero_token_batch_returns_early():
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    eng = DecodeEngine(cfg, model.init(0, device="cpu"), batch_size=2,
                       device="cpu")
    reqs = eng.run([Request(np.arange(3, dtype=np.int32), 0)])
    assert reqs[0].done and reqs[0].out == []
    assert torch.count_nonzero(eng.cache[0]["k"]) == 0  # no step ran
