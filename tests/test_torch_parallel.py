"""The port's tensor-parallel layer on the CPU: the stacked-rank layout,
``tp_ficco_linear`` against the dense product, when the overlap applies,
the tuner-backed mode, the sharded decode attention against the plain
decode, and the paths that are not ported yet raising with their ROADMAP
item."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import OverlapConfig, ShapeConfig
from repro_torch.launch.specs import train_specs
from repro_torch.models import layers
from repro_torch.models.model import build_model
from repro_torch.parallel import tp
from repro_torch.parallel.context import overlap_context
from repro_torch.parallel.sharding import (
    TPGroup,
    active_group,
    shard_columns,
    shard_rows,
    tp_group,
)

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

DMA = OverlapConfig(mode="uniform-fused-1d", backend="dma")


def _rand(*shape, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    )


def test_shard_layout_follows_shard_map_blocks():
    x, w = _rand(8, 3), _rand(3, 8, seed=1)
    rows, cols = shard_rows(x, 4), shard_columns(w, 4)
    for r in range(4):
        assert torch.equal(rows[r], x[2 * r:2 * r + 2])  # P("model", None)
        assert torch.equal(cols[r], w[:, 2 * r:2 * r + 2])  # P(None, "model")
    with pytest.raises(ValueError):
        shard_rows(_rand(6, 3), 4)


def test_tp_group_context_nests_and_restores():
    a, b = TPGroup(2, "cpu"), TPGroup(4, "cpu")
    assert active_group() is None
    with tp_group(a):
        with tp_group(b):
            assert active_group() is b
        assert active_group() is a
    assert active_group() is None
    assert a.copy_stream is None  # no copy stream off CUDA


@pytest.mark.parametrize("b,s", [(1, 64), (3, 32)])
def test_tp_ficco_linear_equals_dense_product(b, s):
    """Seq-major rows per rank, rank-major gather, rank blocks side by
    side: the result is x @ w, row for row."""
    x, w = _rand(b, s, 128, seed=2), _rand(128, 512, seed=3)
    with tp_group(TPGroup(4, "cpu")):
        assert tp.overlap_applicable(x, w)
        got = tp.tp_ficco_linear(x, w, DMA)
    torch.testing.assert_close(got, x @ w, rtol=1e-5, atol=1e-5)


def test_overlap_applicable_needs_group_and_divisible_dims():
    x, w = _rand(2, 64, 16), _rand(16, 64)
    assert not tp.overlap_applicable(x, w)  # no group
    with tp_group(TPGroup(1, "cpu")):
        assert not tp.overlap_applicable(x, w)  # group of one
    with tp_group(TPGroup(4, "cpu")):
        assert tp.overlap_applicable(x, w)
        assert not tp.overlap_applicable(_rand(2, 62, 16), w)  # S % g
        assert not tp.overlap_applicable(x, _rand(16, 66))  # F % g


def test_mlp_takes_dense_path_when_overlap_does_not_apply():
    p = {"w_up": _rand(16, 64, seed=4), "w_gate": _rand(16, 64, seed=5),
         "w_down": _rand(64, 16, seed=6)}
    x = _rand(2, 6, 16, seed=7)  # S = 6 does not divide over 4 ranks
    with overlap_context(DMA), tp_group(TPGroup(4, "cpu")):
        got = layers.mlp_apply(p, x)
    torch.testing.assert_close(got, layers.mlp_apply(p, x))


_MODES = [
    OverlapConfig(mode="serial", backend="dma"),
    OverlapConfig(mode="ficco_auto", backend="collective"),
    OverlapConfig(mode="uniform-fused-1d", backend="collective"),
]


@pytest.mark.parametrize("overlap", _MODES)
def test_every_mode_runs_through_ficco_linear(overlap):
    x, w = _rand(1, 64, 16), _rand(16, 64)
    with tp_group(TPGroup(4, "cpu")):
        got = tp.tp_ficco_linear(x, w, overlap)
    torch.testing.assert_close(got, x @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("overlap", _MODES)
def test_schedules_not_ported_raise_with_roadmap_item(overlap):
    """The tuner-backed mode runs on either backend, and the tuner takes a
    learned gate (ROADMAP A4 step 2 is ported)."""
    from repro_torch.autotune import get_tuner, reset_tuner
    from repro_torch.learn import LearnedGate

    reset_tuner()
    try:
        x, w = _rand(1, 64, 16), _rand(16, 64)
        autotune = dataclasses.replace(overlap, mode="ficco_autotune")
        with tp_group(TPGroup(4, "cpu")):
            got = tp.tp_ficco_linear(x, w, autotune)
        torch.testing.assert_close(got, x @ w, rtol=1e-5, atol=1e-5)
        gate = LearnedGate(tree={"leaf": True, "gate": float("inf")})
        get_tuner().set_gate(gate)
        assert get_tuner().gate is gate
        with tp_group(TPGroup(4, "cpu")):
            torch.testing.assert_close(tp.tp_ficco_linear(x, w, autotune),
                                       x @ w, rtol=1e-5, atol=1e-5)
    finally:
        reset_tuner()


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_other_families_raise_with_roadmap_item(arch):
    """Every family builds, and since ROADMAP A13 the hybrid and SSM
    families train under a TP group too: one AdamW step on
    uniform-fused-2d over 4 ranks, on a ``SyntheticLM`` batch of
    ``train_specs``' shapes, gives dense's metrics and parameters (xLSTM,
    which has no FiCCO site, bit for bit; Jamba, whose MLPs fold through
    K2's plain version, at the model tolerance)."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.tree import leaves

    cfg = get_config(arch).reduced()
    shape = ShapeConfig("t", 16, 2, "train")
    batch = to_device(SyntheticLM(cfg, shape, seed=3).batch_at(1), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        k: (s.shape, s.dtype) for k, s in train_specs(cfg, shape).items()}
    dense = build_model(cfg)
    state = init_train_state(dense, 0, device="cpu")
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
    want, want_m = make_train_step(dense, ocfg)(state, batch)
    cfg_2d = dataclasses.replace(cfg, overlap=OverlapConfig(
        mode="uniform-fused-2d", backend="collective"))
    with tp_group(TPGroup(4, "cpu")):
        got, got_m = make_train_step(build_model(cfg_2d), ocfg)(state, batch)
    tol = (dict(rtol=0, atol=0) if arch == "xlstm-1.3b"
           else dict(rtol=2e-3, atol=2e-3))
    for key in want_m:
        torch.testing.assert_close(got_m[key], want_m[key], **tol, msg=key)
    for g, w in zip(leaves(got["params"]), leaves(want["params"])):
        torch.testing.assert_close(g, w, **tol)


@pytest.mark.parametrize("cache_len,group,sharded", [
    (1024, 4, True),    # the flash-decode over the time-sharded cache
    (8, 4, False),      # S < 1024: falls through to the plain decode
    (1024, None, False),  # no TP group: the plain decode
])
def test_shard_map_decode_attention_matches_plain_decode(
        cache_len, group, sharded, monkeypatch):
    """decode_attn="shard_map" serves the reduced TinyLlama's decode
    through parallel/decode_attn.py where it applies (and the plain
    path elsewhere), with the plain decode's logits and caches."""
    from repro_torch.parallel import decode_attn

    calls = []
    real = decode_attn.shard_map_attn_decode
    monkeypatch.setattr(decode_attn, "shard_map_attn_decode",
                        lambda *a: calls.append(1) or real(*a))
    base = get_config("tinyllama-1.1b").reduced()
    cfg = dataclasses.replace(base,
                              overlap=OverlapConfig(decode_attn="shard_map"))
    model, plain_model = build_model(cfg), build_model(base)
    state = model.init(0, device="cpu")
    toks = torch.as_tensor(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6)))
    caches = [m.init_cache(2, cache_len, device="cpu")
              for m in (model, plain_model)]
    grp = TPGroup(group, "cpu") if group else None
    for pos in range(toks.shape[1]):
        with tp_group(grp), overlap_context(cfg.overlap):
            got, caches[0] = model.decode_step(
                state, caches[0], toks[:, pos:pos + 1], pos)
        want, caches[1] = plain_model.decode_step(
            state, caches[1], toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    for a, b in zip(caches[0], caches[1]):  # one dict per pattern slot
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=2e-3, atol=2e-3)
    assert len(calls) == (cfg.num_layers * toks.shape[1] if sharded else 0)


@pytest.mark.parametrize("tiled", [False, True])
def test_all_gather_matches_lax_on_every_rank(tiled):
    import jax
    import jax.numpy as jnp

    from repro_torch.parallel.collectives import all_gather

    x = np.random.default_rng(3).standard_normal((4, 3, 5)).astype(np.float32)
    want = jax.vmap(
        lambda v: jax.lax.all_gather(v, "r", axis=0, tiled=tiled),
        axis_name="r",
    )(jnp.asarray(x))
    got = all_gather(torch.from_numpy(x)[:, :, 1:], tiled=tiled)  # strided
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[..., 1:])
    assert got.is_contiguous()


@pytest.mark.parametrize("shift", [1, 3])
def test_ppermute_matches_lax_on_every_rank(shift):
    import jax
    import jax.numpy as jnp

    from repro_torch.parallel.collectives import ppermute

    x = np.random.default_rng(4).standard_normal((4, 2, 3)).astype(np.float32)
    perm = [(i, (i + shift) % 4) for i in range(4)]
    want = jax.vmap(lambda v: jax.lax.ppermute(v, "r", perm),
                    axis_name="r")(jnp.asarray(x))
    got = ppermute(torch.from_numpy(x), shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
