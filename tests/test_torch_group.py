"""The tensor-parallel group over processes (``RankGroup``) against the
reference's ``shard_map`` bodies and the port's stacked group.

One spawn of 4 gloo ranks (``repro_torch.launch.group.spawn``) runs every
case of the module inside the ranks (``tests/torch_group_ranks.py``, which
imports no JAX) and pickles the results back:

  * the six per-rank schedules through ``ficco_linear``, in float32 and
    bfloat16, against the reference's ``shard_map`` outputs (the shared
    JAX subprocess's ``collectives`` entry) at 1e-5 and 2e-2, the
    tolerances of ``tests/multidev_driver.py``; each rank's
    ``counting()`` against that entry's ``parse_collectives`` bytes and
    calls by kind;
  * the per-rank collectives against their stacked forms, and
    ``all_reduce`` and ``pmax`` against the reference's ``lax.psum`` and
    ``lax.pmax`` under ``shard_map`` (that entry's ``"reduce"``);
  * the per-rank ``shard_map_attn_decode``, each rank on its time slice,
    against the reference's ``shard_map`` decode attention (the
    subprocess's ``decode_attn`` entry) at 1e-5;
  * a ``DecodeEngine`` per rank on the reduced TinyLlama with
    ``decode_attn="shard_map"`` and a cache of 1024 (256 positions a
    rank), and of 512 (whole on every rank, which the reference's rule
    leaves whole): the same tokens on every rank as the port's engine in
    this process;
  * the K3 + K1 composer and K4 per rank, on their plain versions (gloo's
    all-gather for the exchange), against the stacked port at 1e-5, two
    calls each through the same ring and shards;
  * the reduced TinyLlama prefill across the 4 ranks in
    ``uniform-fused-1d`` on the collective backend and on the DMA
    backend, against the reference's single-device forward in this
    process at 2e-3 (``tests/test_torch_model.py``'s tolerance; R4 rules
    out the reference's sharded forward), every rank's logits (the
    vocabulary blocks gathered) bit-equal, the residual stream between
    layers the rank's (B, S/g, d) sequence block;
  * the EP dispatch per rank (``serial_a2a_ffn`` / ``ficco_a2a_ffn`` with
    ``group=``), each of ``MOE_CASES``, against the reference's
    ``shard_map`` outputs (the subprocess's ``moe`` entry) at 1e-5, with
    ``"reverse"`` bit-equal to ``"default"`` and two all-to-alls counted
    per non-empty chunk;
  * each per-rank collective's gradient against the logical form's
    autograd (``all_reduce``'s the identity; ``psum_scatter``'s the
    all-gather, and the other way round);
  * 2 AdamW steps per rank of the reduced TinyLlama (fp32) on serial,
    uniform-fused-2d and uniform-fused-2d with ``accum_steps=2``, from
    the reference's params cut by ``shard_train_state``, against the
    reference's jitted steps run in this process
    (``torch_jax_reference.train_reference``) at 2e-3: the metrics and
    the replicated leaves bit-equal across ranks, K2's folds and the
    counted (forward) collectives per step; the DMA backend refusing
    grad per rank;
  * each rank holding its blocks of the embedding and unembedding (the
    vocabulary), the attention (heads), the MLPs and the experts by the
    model's ``rank_specs``: the reduced TinyLlama at a prompt of 30
    tokens, which 4 ranks do not divide (the residual stays replicated),
    the reduced DeepSeek-V2-Lite with 8 experts (MLA, 4 heads), a
    SmolLM-like model with 15 / 5 heads (their sharding dropped: the
    ranks gather whole heads) and tied embeddings, SeamlessM4T-v2 (the
    encoder's layers cut too, its 32 frames by sequence), InternVL2 (its
    8 prefix patches joined before 24 tokens and cut by sequence), Jamba
    (its Mamba mixer cut on d_inner, its attention layer by heads) and
    xLSTM (its mLSTM and sLSTM mixers cut on d_inner), each from the
    reference's params cut by ``params_from_jax(rank=)``: prefill logits
    against the reference's one-device forward (the subprocess's
    ``ranks`` entry; Seamless's and InternVL2's from its ``encdec``
    entry, Jamba's and xLSTM's from its ``recurrent`` and
    ``recurrent_grad`` entries) at 2e-3, every rank's bit-equal, and the
    residual's shape between layers (and encoder layers), and for
    Seamless, InternVL2, Jamba and xLSTM at an odd shape too (30 frames,
    8 + 22 positions, 30 tokens: the residual replicated); the recurrent
    layers' decode state (whole at these widths) the same bits on every
    rank after each engine run; ``DecodeEngine``s per rank in both
    ``decode_attn`` modes at a cache the rule time-slices, for a prompt
    length 4 divides and one it does not, against the reference's
    one-device engine's tokens, and against one process's tokens with a
    time-sliced and a whole cache, each cache leaf the rank's block by
    the reference's ``cache_leaf_spec``, Seamless's with its cross K/V
    of 16 encoder positions (whole on every rank) and of 1024 (the
    rank's time slice); ``loss_and_grads``' loss
    (vocab-parallel) and each rank's gradient blocks, the embedding's and
    unembedding's included, and one step's loss and ``grad_norm``,
    against the reference's jitted ones;
  * ``gather_replicated``'s gradient against the logical one: this rank's
    block of the replicated cotangent, not the g-fold sum that
    ``all_gather``'s reduce-scatter gives;
  * an MLA layer with 6 heads, which 4 ranks do not divide while they
    divide every projection's columns (a rank's block straddles heads):
    ``mla_apply`` on the replicated input and on the rank's sequence
    block, its gradients, and ``mla_decode`` on a latent cache the rule
    keeps whole and one it time-slices, against the reference's
    ``mla_apply``, ``jax.grad`` and ``mla_decode`` (jitted in this
    process) at 1e-5;
  * a Mamba layer of d_inner 1024, an mLSTM of 4 heads of 1024 and an
    sLSTM of d_inner 1024 (the narrowest widths at which the reference's
    cache rule cuts their state over 4 ranks): the apply on the
    replicated input and on the rank's sequence block, its gradients,
    and a few decode steps with the state the rank's block by
    ``cache_leaf_spec`` (the mLSTM's ``c`` on its key dim), against the
    reference's layers jitted in this process at 1e-5 of the largest
    value, the whole leaves the same bits on every rank.

Besides: the launcher raises, and leaves no rank running, when one rank
raises; ranks that share a CUDA device refuse plain collectives (decided
on device objects: there is no card here); a ``RankGroup`` with a card
per rank makes its NCCL group while it is built, and raises when two of
its cards lack peer access (``torch.distributed`` and the CUDA queries
patched); ``pmax`` refuses grad; ``train(checkpoint_dir=)`` on a
``RankGroup`` raises, citing ROADMAP A14; ``shard_train_state`` cuts the
params and both moments; each rank's parameter bytes at full width equal
``shard_shape`` over the reference rule's fixed specs on a model-only
mesh of 4 for the cut leaves plus the whole leaves' bytes (Seamless's,
InternVL2's, Jamba-1.5-Large's and xLSTM-1.3B's too), and its decode
cache's; the encoder-decoder's, VLM's, hybrid's and SSM's
``rank_specs`` cut by the rule.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch_group_ranks
import torch_jax_reference as jax_reference

from repro.configs import get_config as jax_get_config
from repro.core.workload import StepProfile as JaxStepProfile
from repro.models.model import build_model as jax_build_model
from repro.overlap.moe import skewed_chunk_sizes as jax_skewed_chunk_sizes
from repro.tune.variants import default_variant as jax_default_variant
from repro_torch.configs import get_config
from repro_torch.core.schedule_types import Schedule
from repro_torch.core.workload import StepProfile
from repro_torch.kernels.dma_exchange import ficco_uniform_fused_1d_dma
from repro_torch.kernels.ficco_ag_matmul import ficco_ag_matmul_fused
from repro_torch.launch.group import spawn
from repro_torch.models.model import build_model
from repro_torch.parallel import collectives
from repro_torch.parallel.group import RankGroup, plain_backend
from repro_torch.parallel.sharding import (rank_blocks, shard_params,
                                           shard_train_state, tp_group)
from repro_torch.tune.variants import KernelVariant, default_variant

# The pytest-xdist workers share the host's cores: one intra-op thread
# each, or the small tensors here spend their time oversubscribing them.
torch.set_num_threads(1)

G = 4
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "tinyllama-1.1b"
# The composer's and K4's shards: m_s 256 rows of K 64 into n_local 128,
# so the default variant's (256, 64) @ (64, 128) step takes K1's tile.
COMPOSER = dict(m_s=256, k=64, n_local=128, seed=51)
VARIANTS = (
    dict(chunks=4, block_m=128, block_n=128, block_k=128),
    dict(chunks=2, block_m=128, block_n=128, block_k=128, buffer_depth=2,
         dispatch_order="reverse"),
)
PREFILL_MODES = (("uniform-fused-1d", "collective"),
                 ("uniform-fused-1d", "dma"))
# Training per rank (reduced TinyLlama, fp32, 2 steps): (mode, accum_steps)
# on the collective backend.
TRAIN_MODES = (("serial", 1), ("uniform-fused-2d", 1), ("uniform-fused-2d", 2))
# K2 folds per forward on the 2D path: 2 layers x (up, gate) x 4 K slices.
FOLDS_2D = 16
# The engine per rank (the subprocess's RANK_ENGINE): prompts of each
# length, new tokens each; a cache the reference's rule time-slices and
# one it keeps whole on every rank.
ENGINE = dict(jax_reference.RANK_ENGINE, whole=512)
PROMPT = ENGINE["prompts"][0]
DECODE_ATTN = ("gspmd", "shard_map")
# The per-rank models held to the subprocess's ``ranks`` entry: the
# prefill's backends and the training mode (collective backend) of each.
RANK_MODELS = {"dense": (("collective", "dma"), "serial"),
               "deepseek": (("collective", "dma"), "uniform-fused-2d"),
               "smollm": (("collective",), "serial"),
               "indivisible": (("collective",), "serial"),
               "seamless": (("collective", "dma"), "uniform-fused-2d"),
               "internvl": (("collective", "dma"), "uniform-fused-2d"),
               "jamba": (("collective", "dma"), "uniform-fused-2d"),
               "xlstm": (("collective",), "serial")}
# The rank models whose prefill also runs at an odd shape (RANK_ODD: the
# encoder's 30 frames, the VLM's 8 + 22 joined positions, the hybrid's and
# SSM's 30 tokens).
ODD = jax_reference.RANK_ODD_PREFILL
MLA = jax_reference.RANK_MLA
# The MLA layer case's decode caches: one the rule keeps whole, one whose
# time axis it cuts.
MLA_CACHES = (64, 1024)
# The recurrent layer cases (Mamba, mLSTM, sLSTM) at the widths where the
# rule cuts their decode state.
RECURRENT = jax_reference.RANK_RECURRENT
# The rank models with recurrent layers.
RECURRENT_MODELS = ("jamba", "xlstm")


@pytest.fixture(scope="module", autouse=True)
def _start_reference(tmp_path_factory):
    """The JAX subprocess runs while the ranks run."""
    jax_reference.start(tmp_path_factory)


@pytest.fixture(scope="module")
def model_reference():
    cfg = jax_get_config(ARCH).reduced()
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 512)).astype(np.int32)
    logits, _ = jax.jit(model.forward)(params, {"tokens": tokens})
    return dict(numpy_params=jax.tree.map(np.asarray, params), tokens=tokens,
                logits=np.asarray(logits, np.float32))


def _encs(cfg) -> tuple:
    """An engine's encoder lengths: ``RANK_ENC``'s for an encoder-decoder
    (its cross cache whole, then time-sliced), else 0."""
    return jax_reference.RANK_ENC if cfg.encdec else (0,)


def _engine_runs(cfg) -> list:
    """Each rank model's engines: both decode attentions at the cache the
    rule time-slices for each prompt length, at each encoder length, and
    ``decode_attn="shard_map"`` at one it keeps whole, at the first; an
    encoder-decoder's engine encodes ``engine_frames`` first."""
    encs = _encs(cfg)
    runs = [(mode, ENGINE["cache"], length, enc) for enc in encs
            for mode in DECODE_ATTN for length in ENGINE["prompts"]]
    runs.append(("shard_map", ENGINE["whole"], PROMPT, encs[0]))
    return [(mode, cache, jax_reference.engine_prompts(cfg.vocab_size, length),
             ENGINE["new"], enc,
             jax_reference.engine_frames(cfg.d_model, enc) if enc else None)
            for mode, cache, length, enc in runs]


def _composer_operands():
    rng = np.random.default_rng(COMPOSER["seed"])
    x = rng.standard_normal((G, COMPOSER["m_s"], COMPOSER["k"]))
    w = rng.standard_normal((G, COMPOSER["k"], COMPOSER["n_local"]))
    return x.astype(np.float32), w.astype(np.float32)


def _ep_cases() -> dict:
    """``MOE_CASES``' keyword arguments for the port's ``ficco_a2a_ffn``
    (None: ``serial_a2a_ffn``), as the reference's entry runs them."""
    g = jax_reference.MOE["g"]
    reverse = dataclasses.replace(
        default_variant("ficco_a2a_ffn", group=g), dispatch_order="reverse")
    kwargs = {
        "serial": None,
        "default": {},
        "chunks3": {"chunks": 3},
        "reverse": {"variant": reverse},
        "skewed": {"profile": StepProfile.skewed(g, jax_reference.MOE_SKEW)},
        "sizes": {"chunk_sizes": jax_reference.MOE_SIZES},
    }
    return {name: kwargs[name] for name in jax_reference.MOE_CASES}


def _grad_operands():
    """x (g, g, 3, 5) and each collective's output cotangent: stacked by
    rank, or one replicated array for ``all_reduce``."""
    rng = np.random.default_rng(54)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x = draw(G, G, 3, 5)
    return x, {"psum_scatter": draw(G, 1, 3, 5),
               "all_gather_axis1": draw(G, G, G * 3, 5),
               "all_gather": draw(G, G, G, 3, 5),
               "all_gather_tiled": draw(G, G * G, 3, 5),
               "all_to_all": draw(G, G, 3, 5),
               "ppermute": draw(G, G, 3, 5),
               "ppermute_back": draw(G, G, 3, 5),
               "all_reduce": draw(G, 3, 5)}


def _rank_cfg(name: str):
    if name == "dense":
        return get_config(ARCH).reduced()
    return jax_reference.rank_config(get_config, name)


def _rank_shape(name: str) -> dict:
    return (jax_reference.RANK_ODD if name == "dense"
            else jax_reference.RANK_TRAIN)


def _rank_batch(name: str, shape: dict | None = None) -> dict:
    """SyntheticLM's batch 0 at the model's shape (``RANK_ODD`` for the
    dense model, ``RANK_TRAIN`` for the others) or at ``shape``; numpy,
    with a VLM's prefix or an encoder-decoder's frames, as the
    reference's entry draws it."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM

    t = shape or _rank_shape(name)
    return SyntheticLM(_rank_cfg(name), ShapeConfig("t", t["seq"], t["batch"],
                                                    "train"),
                       seed=t["seed"]).batch_at(0)


def _mla_cfg(get):
    """The MLA layer case's latent and head widths (the reduced
    DeepSeek-V2-Lite's) from either package's ``get_config``."""
    return get("deepseek-v2-lite-16b").reduced()


def _mla_operands() -> tuple:
    """The MLA layer case's params, x and output cotangent (numpy)."""
    cfg = _mla_cfg(get_config)
    return jax_reference.mla_operands(cfg.d_model, cfg.mla)


@pytest.fixture(scope="module")
def rank_params(model_reference):
    """Each of ``RANK_MODELS``' params from ``PRNGKey(0)``, as the
    subprocess's ``ranks`` entry draws them (numpy)."""
    params = {name: jax.tree.map(np.asarray, jax_build_model(
        jax_reference.rank_config(jax_get_config, name)).init(
            jax.random.PRNGKey(0))) for name in RANK_MODELS
        if name != "dense"}
    params["dense"] = model_reference["numpy_params"]
    return params


def _gather_operands():
    """x (g, m, n) and the replicated cotangent (m, g * n) of its
    gathered dim 1."""
    rng = np.random.default_rng(55)
    return (rng.standard_normal((G, 3, 5)).astype(np.float32),
            rng.standard_normal((3, G * 5)).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(model_reference, rank_params, tmp_path_factory):
    """Every rank's results of :func:`torch_group_ranks.run_all`."""
    train = jax_reference.TRAIN
    cases = {
        "schedules": jax_reference.schedule_operands(),
        "collectives": np.random.default_rng(52).standard_normal(
            (G, G, 3, 5)).astype(np.float32),
        "reductions": jax_reference.reduce_operands(),
        "decode_attention": (jax_reference.decode_attn_operands(),
                             jax_reference.DECODE_ATTN_POS),
        "composers": (*_composer_operands(), VARIANTS),
        "prefill_modes": PREFILL_MODES,
        "params": model_reference["numpy_params"],
        "tokens": model_reference["tokens"],
        "ep": (*jax_reference.moe_operands(), _ep_cases()),
        "collective_grads": _grad_operands(),
        "train_modes": TRAIN_MODES,
        "train": ((train["seq"], train["batch"]), train["ocfg"],
                  train["steps"]),
        "gather_grad": _gather_operands(),
        "rank_models": {
            name: (_rank_cfg(name), rank_params[name], _rank_batch(name),
                   backends, _engine_runs(_rank_cfg(name)), mode,
                   _rank_batch(name, jax_reference.RANK_ODD)
                   if name in ODD else None)
            for name, (backends, mode) in RANK_MODELS.items()},
        "mla": (_mla_operands()[0], _mla_cfg(get_config).mla, MLA["heads"],
                *_mla_operands()[1:], MLA["decode"], MLA_CACHES),
        "recurrent": (RECURRENT["kinds"],
                      [jax_reference.recurrent_layer_config(get_config, kind)
                       for kind in RECURRENT["kinds"]], RECURRENT["decode"]),
    }
    with pytest.MonkeyPatch.context() as mp:
        # The ranks resolve no promoted variant from the home directory.
        mp.setenv("REPRO_AUTOTUNE_CACHE_DIR",
                  str(tmp_path_factory.mktemp("group_autotune")))
        return spawn(torch_group_ranks.run_all, G, device="cpu",
                     args=(cases,), timeout=240)


@pytest.fixture(scope="module")
def reference_collectives(tmp_path_factory):
    return jax_reference.reference(tmp_path_factory, entry="collectives")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sched", [s.value for s in Schedule])
def test_rank_schedule_matches_shard_map(ranks, reference_collectives,
                                         sched, dtype):
    want = reference_collectives["outputs"][dtype][sched]
    n = want.shape[1] // G
    for r, res in enumerate(ranks):
        got = res["schedules"][dtype, sched][0]
        np.testing.assert_allclose(got, want[:, r * n:(r + 1) * n],
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("sched", [s.value for s in Schedule])
def test_rank_counting_matches_parse_collectives(ranks,
                                                 reference_collectives,
                                                 sched):
    want_bytes, want_counts = reference_collectives[sched]
    for res in ranks:
        _, got_bytes, got_counts = res["schedules"]["float32", sched]
        assert got_bytes == want_bytes
        assert got_counts == want_counts


def test_rank_collectives_match_stacked(ranks):
    x = torch.from_numpy(np.random.default_rng(52).standard_normal(
        (G, G, 3, 5)).astype(np.float32))
    want = {
        "all_gather": collectives.all_gather(x),
        "all_gather_tiled": collectives.all_gather(x, tiled=True),
        "all_to_all": collectives.all_to_all(x),
        "ppermute": collectives.ppermute(x, 1),
        "ppermute_back": collectives.ppermute(x, -1),
    }
    total = x.sum(0)
    scattered = collectives.psum_scatter(x, 0)
    for r, res in enumerate(ranks):
        got = res["collectives"]
        for name, stacked in want.items():
            np.testing.assert_array_equal(got[name], stacked[r].numpy(),
                                          err_msg=name)
        np.testing.assert_allclose(got["all_reduce"], total.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["psum_scatter"], total[r:r + 1],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["psum_scatter"],
                                   scattered[r].numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["all_reduce"],
                                      ranks[0]["collectives"]["all_reduce"])


@pytest.mark.parametrize("name", ["psum", "pmax"])
def test_rank_reductions_match_lax(ranks, reference_collectives, name):
    want = reference_collectives["reduce"][name]
    for res in ranks:
        got = res["reductions"][name]
        if name == "pmax":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got, ranks[0]["reductions"][name])


@pytest.mark.parametrize("pos", jax_reference.DECODE_ATTN_POS)
def test_rank_decode_attention_matches_shard_map(ranks, tmp_path_factory,
                                                 pos):
    """Each rank's output and its slice of the updated caches against the
    reference's ``shard_map`` body on a mesh of 4."""
    want_out, want_k, want_v = jax_reference.reference(
        tmp_path_factory)["decode_attn"][pos]
    s_loc = want_k.shape[1] // G
    for r, res in enumerate(ranks):
        out, k, v, in_place = res["decode_attention"][pos]
        assert in_place
        rows = slice(r * s_loc, (r + 1) * s_loc)
        np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(k, want_k[:, rows], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(v, want_v[:, rows], rtol=1e-5, atol=1e-5)


def _one_process_tokens(numpy_params, cache_len: int, cfg=None,
                        enc_len: int = 0) -> list:
    """The port's engine on the whole model (``cfg``, the reduced
    TinyLlama by default), in this process, on the prompts of ``PROMPT``
    tokens; an encoder-decoder's after encoding ``engine_frames`` of
    ``enc_len``."""
    from repro_torch.configs.base import OverlapConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.serve.engine import DecodeEngine, Request

    cfg = dataclasses.replace(cfg or get_config(ARCH).reduced(),
                              overlap=OverlapConfig(decode_attn="shard_map"))
    state = params_from_jax(numpy_params, cfg, device="cpu")
    eng = DecodeEngine(cfg, state, batch_size=ENGINE["batch"],
                       cache_len=cache_len, enc_len=enc_len, device="cpu")
    if enc_len:
        eng.encode(torch.from_numpy(jax_reference.engine_frames(
            cfg.d_model, enc_len)))
    reqs = eng.run([Request(p, ENGINE["new"]) for p in
                    jax_reference.engine_prompts(cfg.vocab_size, PROMPT)])
    want = [list(r.out) for r in reqs]
    assert all(len(t) == ENGINE["new"] for t in want)
    return want


def _positions(res, name: str, cache_len: int, enc_len: int = 0) -> tuple:
    """The tokens of a rank's ``shard_map`` engine at ``cache_len`` (and
    ``enc_len``) on the prompts of ``PROMPT`` tokens, and the positions
    its first attention layer's cache holds (K's, or MLA's latent's;
    None without one: the SSM family)."""
    tokens, leaves = res["model", name]["engine"][
        "shard_map", cache_len, PROMPT, enc_len]
    held = [c["k" if "k" in c else "c_kv"][2] for c in leaves
            if "k" in c or "c_kv" in c]
    return tokens, (held[0] if held else None)


def test_rank_decode_engine_matches_one_process(ranks, model_reference):
    """Every rank's engine (its blocks of the attention and the MLPs, its
    quarter of the cache) gives the tokens of the port's engine on the
    whole model here."""
    want = _one_process_tokens(model_reference["numpy_params"],
                               ENGINE["cache"])
    for res in ranks:
        tokens, positions = _positions(res, "dense", ENGINE["cache"])
        assert positions == ENGINE["cache"] // G
        assert tokens == want


def test_rank_decode_engine_serves_a_cache_the_guard_refuses(
        ranks, model_reference):
    """A cache of 512 (under the reference's 1024) stays whole on every
    rank and takes the plain decode, as the reference's fallback does:
    the same tokens as the engine here."""
    want = _one_process_tokens(model_reference["numpy_params"],
                               ENGINE["whole"])
    for res in ranks:
        tokens, positions = _positions(res, "dense", ENGINE["whole"])
        assert positions == ENGINE["whole"]
        assert tokens == want


@pytest.mark.parametrize("kernel", ["dma_exchange", "ficco_ag_matmul"])
@pytest.mark.parametrize("spec", VARIANTS,
                         ids=["default", "chunks2_reverse"])
def test_composer_and_k4_per_rank_match_stacked(ranks, kernel, spec):
    x, w = (torch.from_numpy(a) for a in _composer_operands())
    variant = KernelVariant(kernel=kernel, **spec)
    fn = (ficco_uniform_fused_1d_dma if kernel == "dma_exchange"
          else ficco_ag_matmul_fused)
    want = fn(x, w, variant=variant)  # (g, g * m_s, n_local), stacked
    key = (kernel, tuple(sorted(spec.items())))
    for r, res in enumerate(ranks):
        for call in res["composers"][key]:
            np.testing.assert_allclose(call, want[r].numpy(), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("mode,backend", PREFILL_MODES)
def test_prefill_across_ranks_matches_reference(ranks, model_reference,
                                                mode, backend):
    logits = [res["prefill", mode, backend][0] for res in ranks]
    np.testing.assert_allclose(logits[0], model_reference["logits"],
                               **MODEL_TOL)
    for other in logits[1:]:
        np.testing.assert_array_equal(other, logits[0])


def _layout_cases() -> list:
    """(model, backend): the dense model at 512 tokens (the prefill
    modes' backends), each rank model at its batch, and the odd shape of
    each of ``ODD`` (collective backend)."""
    return ([("dense-512", backend) for _, backend in PREFILL_MODES]
            + [(name, backend) for name, (backends, _) in RANK_MODELS.items()
               for backend in backends]
            + [(name, "odd") for name in ODD])


def _layout(cfg, batch: dict) -> list:
    """The residual's shape after each encoder layer and decoder period
    of a prefill on ``batch`` on a rank of G: the rank's (B, S/G, d)
    sequence block where G divides the length S (the encoder's frames;
    a VLM's prefix and text joined), else the whole (B, S, d)."""
    def block(b, s):
        return (b, s // G if s % G == 0 else s, cfg.d_model)

    b, s = batch["tokens"].shape
    shapes = []
    if "enc_frames" in batch:
        shapes += ([block(b, batch["enc_frames"].shape[1])]
                   * cfg.encdec.encoder_layers)
    if "prefix_embeds" in batch:
        s += batch["prefix_embeds"].shape[1]
    periods = cfg.num_layers // len(build_model(cfg).pattern)
    return shapes + [block(b, s)] * periods


@pytest.mark.parametrize("name,backend", _layout_cases())
def test_rank_residual_between_layers(ranks, model_reference, name,
                                      backend):
    """After every period the residual stream is the rank's (B, S/g, d)
    sequence block where 4 divides S (512 and 32 tokens; 32 frames and 32
    positions of the VLM's prefix and text), and the whole (B, S, d)
    where it does not (the dense model's 30 tokens, the odd shapes' 30
    frames and 8 + 22 positions); likewise after each encoder layer."""
    if name == "dense-512":
        batch = {"tokens": model_reference["tokens"]}
        cfg = get_config(ARCH).reduced()
        got = [res["prefill", "uniform-fused-1d", backend][1]
               for res in ranks]
    elif backend == "odd":
        batch, cfg = _rank_batch(name, jax_reference.RANK_ODD), \
            _rank_cfg(name)
        got = [res["model", name]["prefill_odd"][1] for res in ranks]
    else:
        batch, cfg = _rank_batch(name), _rank_cfg(name)
        got = [res["model", name]["prefill"][backend][1] for res in ranks]
    want = _layout(cfg, batch)
    if name in ODD:  # whole at the odd shape, cut at the other
        assert all(sh[1] % G for sh in want) is (backend == "odd")
    for shapes in got:
        assert shapes == want


def test_launcher_raises_when_a_rank_raises():
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised") as err:
        spawn(torch_group_ranks.raise_on, 2, device="cpu", args=(1,),
              timeout=60)
    assert "fails on purpose" in str(err.value)


def test_ranks_sharing_a_card_refuse_plain_collectives():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="ROADMAP A9"):
        plain_backend([card] * G)
    with pytest.raises(RuntimeError, match="ROADMAP A9"):
        plain_backend([card, torch.device("cuda", 1), card])
    assert plain_backend([torch.device("cuda", r) for r in range(G)]) \
        == "nccl"
    assert plain_backend([card, card], hosts=["a", "b"]) == "nccl"
    assert plain_backend([cpu] * G) == "gloo"
    with pytest.raises(ValueError):
        plain_backend([cpu, card])


def _patched_rank_group(monkeypatch, devices, peer_access=None):
    """``RankGroup(0, len(devices))`` whose gathered devices are
    ``devices`` on one host, with no process group, no exported memory
    and ``can_device_access_peer`` replaced; returns it and the
    ``new_group`` calls it made."""
    from repro_torch.parallel import group as group_mod

    class Peers:
        def __init__(self, *args):
            pass

        def gather_object(self, obj):
            return [("host", d) for d in devices]

    calls = []
    monkeypatch.setattr(group_mod, "PeerMemory", Peers)
    monkeypatch.setattr(group_mod.dist, "init_process_group",
                        lambda *a, **k: None)
    monkeypatch.setattr(group_mod.dist, "new_group",
                        lambda **kw: calls.append(kw) or "nccl group")
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        peer_access or (lambda a, b: True))
    group = RankGroup(0, len(devices), addr="127.0.0.1", port=1,
                      device="cpu")
    return group, calls


def test_rank_group_builds_its_nccl_group_when_built(monkeypatch):
    group, calls = _patched_rank_group(
        monkeypatch, [f"cuda:{r}" for r in range(G)])
    assert calls == [{"backend": "nccl"}]  # made in __init__, not lazily
    assert group.plain == "nccl group"
    assert calls == [{"backend": "nccl"}]


def test_rank_group_raises_without_peer_access(monkeypatch):
    with pytest.raises(RuntimeError, match="cuda:2 cannot access cuda:1"):
        _patched_rank_group(monkeypatch, [f"cuda:{r}" for r in range(G)],
                            lambda a, b: (a, b) != (2, 1))


def test_rank_group_sharing_a_card_raises_at_first_plain_collective(
        monkeypatch):
    group, calls = _patched_rank_group(monkeypatch, ["cuda:0"] * G)
    assert calls == []
    with pytest.raises(RuntimeError, match="ROADMAP A9"):
        group.plain


def test_collective_refuses_a_logical_group():
    from repro_torch.parallel.sharding import TPGroup

    with pytest.raises(TypeError, match="RankGroup"):
        collectives.all_reduce(torch.ones(2), group=TPGroup(2, "cpu"))


def test_shard_mlp_params_keeps_rank_blocks():
    """``shard_params`` by the model's ``rank_specs``: the embedding's
    vocabulary rows and the unembedding's columns, the attention's
    (MLA's) heads, the experts and the shared MLP cut to rank 1's blocks;
    the norms, the router and MLA's latent projections whole (the same
    tensors)."""
    cfg = _rank_cfg("deepseek")
    model = build_model(cfg)
    state = model.init(0, device="cpu")
    got = shard_params(state, model.rank_specs(G), 1, G)
    v = cfg.vocab_size // G
    assert torch.equal(got["embed"], state["embed"][v:2 * v])
    assert torch.equal(got["unembed"], state["unembed"][:, v:2 * v])
    assert got["final_norm"]["scale"] is state["final_norm"]["scale"]
    want, cut = state["layers"][0], got["layers"][0]
    assert cut["norm1"]["scale"] is want["norm1"]["scale"]
    attn, mla = cut["attn"], want["attn"]
    for key in ("wq", "w_uk", "w_uv"):
        n = mla[key].shape[-1] // G
        assert torch.equal(attn[key], mla[key][..., n:2 * n])
        assert attn[key].is_contiguous()
    n = mla["wo"].shape[1] // G
    assert torch.equal(attn["wo"], mla["wo"][:, n:2 * n])
    assert attn["w_dkv"] is mla["w_dkv"] and attn["w_kr"] is mla["w_kr"]
    ffn, moe = cut["ffn"], want["ffn"]
    assert ffn["router"] is moe["router"]
    e = cfg.moe.num_experts // G
    for key in ("w_up", "w_gate", "w_down"):
        assert torch.equal(ffn[key], moe[key][:, e:2 * e])  # experts kept
    n = moe["shared"]["w_down"].shape[1] // G
    assert torch.equal(ffn["shared"]["w_down"],
                       moe["shared"]["w_down"][:, n:2 * n])


def test_params_from_jax_cuts_a_rank(rank_params):
    """The converter's cut, on numpy, equals ``shard_params`` of the whole
    converted state."""
    from repro_torch.convert import params_from_jax
    from repro_torch.tree import leaves

    cfg = _rank_cfg("deepseek")
    whole = params_from_jax(rank_params["deepseek"], cfg, device="cpu")
    specs = build_model(cfg).rank_specs(G)
    for r in range(G):
        got = params_from_jax(rank_params["deepseek"], cfg, device="cpu",
                              rank=r, size=G)
        want = shard_params(whole, specs, r, G)
        for a, b in zip(leaves(got), leaves(want), strict=True):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["seamless", "internvl"])
def test_params_from_jax_and_shard_train_state_cut_the_encoder_and_prefix(
        rank_params, name):
    """The converter's cut of the encoder-decoder and the VLM equals
    ``shard_params`` of the whole converted state, and
    ``shard_train_state`` cuts the moments alike: the encoder's attention
    and MLP leaves are blocks, ``enc_norm`` and ``frontend_proj`` whole."""
    from repro_torch.convert import params_from_jax
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import leaves, named_leaves

    cfg = _rank_cfg(name)
    whole = params_from_jax(rank_params[name], cfg, device="cpu")
    specs = build_model(cfg).rank_specs(G)
    want = [path.split("/")[0] == "encoder"
            and path.split("/")[1] in ("attn", "ffn")
            for path, _ in named_leaves(whole)]
    assert any(want) is (name == "seamless")
    kept = [path.split("/")[0] in ("enc_norm", "frontend_proj")
            for path, _ in named_leaves(whole)]
    assert any(kept)
    state = {"params": whole, "opt_state": opt.init_state(whole)}
    for r in range(G):
        got = params_from_jax(rank_params[name], cfg, device="cpu",
                              rank=r, size=G)
        for a, b in zip(leaves(got), leaves(shard_params(whole, specs, r, G)),
                        strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
        cut = shard_train_state(state, specs, r, G)
        for part in (cut["params"], cut["opt_state"]["m"],
                     cut["opt_state"]["v"]):
            blocks = rank_blocks(part, specs)
            assert all(blocks[i] for i, w in enumerate(want) if w)
            assert not any(blocks[i] for i, k in enumerate(kept) if k)


def test_missing_stream_memory_operations_raise():
    """The driver's and the runtime's "not supported" (as the CUDA source
    returns them) name the missing capability; nothing falls back."""
    from repro_torch.kernels import peer_memory

    for err in (-801, 801):
        with pytest.raises(RuntimeError, match="stream memory operations"):
            peer_memory.check(err)


def test_rank_group_needs_a_device_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        RankGroup(0, 1, addr="127.0.0.1", port=1)


# ---------------------------------------------------------------------------
# The EP dispatch per rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dispatch_reference(tmp_path_factory):
    return jax_reference.reference(tmp_path_factory)["moe"]


@pytest.mark.parametrize("name", jax_reference.MOE_CASES)
def test_rank_ep_dispatch_matches_shard_map(ranks, dispatch_reference,
                                            name):
    """Each rank's (E, C, D) block of the reference's ``shard_map`` output
    of ``serial_a2a_ffn`` / ``ficco_a2a_ffn``, at 1e-5 in fp32."""
    for r, res in enumerate(ranks):
        got, _ = res["ep"][name]
        np.testing.assert_allclose(got, dispatch_reference[name][r],
                                   rtol=TOL["float32"], atol=TOL["float32"])


def test_rank_ep_reverse_is_bit_equal_to_default(ranks):
    for res in ranks:
        np.testing.assert_array_equal(res["ep"]["reverse"][0],
                                      res["ep"]["default"][0])


def _ep_chunks(name: str) -> int:
    """The non-empty chunks the reference's cut gives each case."""
    c, g = jax_reference.MOE["c"], jax_reference.MOE["g"]
    if name == "serial":
        return 1
    if name == "chunks3":
        return 3
    if name == "skewed":
        sizes = jax_skewed_chunk_sizes(c, JaxStepProfile.skewed(
            g, jax_reference.MOE_SKEW))
        return sum(1 for s in sizes if s)
    if name == "sizes":
        return sum(1 for s in jax_reference.MOE_SIZES if s)
    return jax_default_variant("ficco_a2a_ffn", group=g).chunks


@pytest.mark.parametrize("name", jax_reference.MOE_CASES)
def test_rank_ep_counts_two_all_to_alls_per_chunk(ranks, name):
    for res in ranks:
        _, counts = res["ep"][name]
        assert counts == {"all-to-all": 2 * _ep_chunks(name)}


# ---------------------------------------------------------------------------
# Gradients per rank
# ---------------------------------------------------------------------------

def _logical_grads():
    """Each collective's gradient in the logical form, by autograd over
    the stacked ranks: the reference's transposes."""
    x, cot = _grad_operands()
    fns = {
        "psum_scatter": lambda v: collectives.psum_scatter(v, 0),
        "all_gather_axis1": lambda v: collectives.all_gather(
            v, tiled=True, axis=1),
        "all_gather": collectives.all_gather,
        "all_gather_tiled": lambda v: collectives.all_gather(v, tiled=True),
        "all_to_all": collectives.all_to_all,
        "ppermute": lambda v: collectives.ppermute(v, 1),
        "ppermute_back": lambda v: collectives.ppermute(v, -1),
        # psum's output is one replicated array: its cotangent reaches
        # every rank's block once.
        "all_reduce": lambda v: v.sum(0),
    }
    out = {}
    for name, fn in fns.items():
        xt = torch.from_numpy(x).requires_grad_(True)
        (grad,) = torch.autograd.grad(fn(xt), xt, torch.from_numpy(cot[name]))
        out[name] = grad.numpy()
    return out


@pytest.mark.parametrize("name", ["psum_scatter", "all_gather_axis1",
                                  "all_gather", "all_gather_tiled",
                                  "all_to_all", "ppermute", "ppermute_back",
                                  "all_reduce"])
def test_rank_collective_grad_matches_logical(ranks, name):
    want = _logical_grads()[name]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["collective_grads"][name], want[r],
                                   rtol=1e-6, atol=1e-6)


def test_pmax_refuses_grad():
    from repro_torch.parallel.group import RankGroup as Group

    group = Group.__new__(Group)
    group._plain, group.size, group.rank = "gloo group", 2, 0
    with pytest.raises(RuntimeError, match="no reverse-mode rule"):
        collectives.pmax(torch.ones(2, requires_grad=True), group=group)


# ---------------------------------------------------------------------------
# Training per rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_reference():
    return jax_reference.train_reference()


def _rank_want(train_reference, rank: int) -> list:
    """The reference's state after the last step, cut to ``rank``'s
    blocks, as numpy leaves in the port's order."""
    from repro_torch.convert import opt_state_from_jax, params_from_jax
    from repro_torch.tree import leaves

    cfg = get_config(ARCH).reduced()
    want = train_reference["states"][-1]
    state = {"params": params_from_jax(want["params"], cfg, device="cpu"),
             "opt_state": opt_state_from_jax(want["opt_state"], cfg,
                                             device="cpu")}
    specs = build_model(cfg).rank_specs(G)
    return [t.numpy()
            for t in leaves(shard_train_state(state, specs, rank, G))]


@pytest.mark.parametrize("mode,accum", TRAIN_MODES)
def test_rank_train_matches_reference(ranks, train_reference, mode, accum):
    """Each step's metrics and every leaf of the last state, cut to the
    rank's blocks, within 2e-3 of the reference's jitted steps."""
    for r, res in enumerate(ranks):
        got = res["train", mode, accum]
        for m, want_m in zip(got["metrics"], train_reference["metrics"],
                             strict=True):
            for k in ("loss", "ce", "aux", "lr", "grad_norm"):
                np.testing.assert_allclose(m[k], want_m[k], **MODEL_TOL,
                                           err_msg=k)
        want = _rank_want(train_reference, r)
        assert len(got["leaves"]) == len(want)
        for a, b in zip(got["leaves"], want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, **MODEL_TOL)


@pytest.mark.parametrize("mode,accum", TRAIN_MODES)
def test_rank_train_replicated_leaves_bit_equal(ranks, mode, accum):
    """The metrics and every replicated leaf are the same bits on every
    rank; the blocks (the embedding and unembedding, the attention's four
    weights and the MLP's three, with ``m`` and ``v``) differ."""
    first = ranks[0]["train", mode, accum]
    assert sum(first["blocks"]) == 3 * 9  # params, m, v x 9 weights
    for res in ranks[1:]:
        got = res["train", mode, accum]
        assert got["metrics"] == first["metrics"]
        assert got["blocks"] == first["blocks"]
        for a, b, block in zip(got["leaves"], first["leaves"],
                               first["blocks"]):
            if not block:
                np.testing.assert_array_equal(a, b)
            else:
                assert not np.array_equal(a, b)


@pytest.mark.parametrize("mode,accum", TRAIN_MODES)
def test_rank_train_k2_folds(ranks, mode, accum):
    """K2 folds each up/gate step of the 2D path per rank: 16 per forward
    (one forward per microbatch); none on serial."""
    per_step = FOLDS_2D * accum if mode == "uniform-fused-2d" else 0
    for res in ranks:
        assert res["train", mode, accum]["folds"] == \
            [per_step] * jax_reference.TRAIN["steps"]


@pytest.mark.parametrize("mode,accum", TRAIN_MODES)
def test_rank_train_counts_the_forward_collectives_only(ranks, mode, accum):
    """``counting()`` around a step records each microbatch's forward
    collectives (the residual cut by sequence: the embedding's
    reduce-scatter; in each layer the attention's all-gather of its input
    and each MLP's up and gate all-gathers, one per K slice on the 2D
    path, and the reduce-scatters of the attention's and the MLP's output
    projections; the unembedding's all-gather; the vocab-parallel loss's
    ``pmax`` and two all-reduces; the heads divide by the group, so the
    attention gathers no heads) and the global norm's all-reduce; the
    backward's reduce-scatters and all-gathers go uncounted."""
    layers = get_config(ARCH).reduced().num_layers
    gathers = 2 * (G if mode == "uniform-fused-2d" else 1)
    want = {"all-gather": (layers * (1 + gathers) + 1) * accum,
            "reduce-scatter": (2 * layers + 1) * accum,
            "all-reduce": 3 * accum + 1}
    for res in ranks:
        assert res["train", mode, accum]["collectives"] == \
            [want] * jax_reference.TRAIN["steps"]


def test_rank_dma_backend_refuses_grad(ranks):
    for res in ranks:
        assert "no reverse-mode rule" in res["dma_grad"]


def test_train_with_checkpoints_on_a_rank_group_raises(monkeypatch,
                                                       tmp_path):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.loop import train

    group, _ = _patched_rank_group(monkeypatch, ["cpu"] * G)
    with tp_group(group), pytest.raises(NotImplementedError,
                                        match="ROADMAP A14"):
        train(get_config(ARCH).reduced(), ShapeConfig("t", 16, 2, "train"),
              steps=1, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert not any(tmp_path.iterdir())


def test_shard_train_state_cuts_params_and_moments():
    """The params and both moments cut by the model's ``rank_specs``: the
    embedding and unembedding and the attention's and the MLP's weights
    (the leaves under ``attn`` and ``ffn``) are blocks, every other leaf
    whole; ``step`` as it is."""
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import named_leaves

    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    state = {"params": params, "opt_state": opt.init_state(params)}
    for key in ("m", "v"):  # moments that differ from the params
        state["opt_state"][key] = model.init(1 + len(key), device="cpu")
    specs = model.rank_specs(G)
    got = shard_train_state(state, specs, 2, G)
    assert got["opt_state"]["step"] is state["opt_state"]["step"]
    want = [path.split("/")[2:3] in (["attn"], ["ffn"])
            or path in ("embed", "unembed")
            for path, _ in named_leaves(params)]
    assert sum(want) == 9
    for part in (got["params"], got["opt_state"]["m"],
                 got["opt_state"]["v"]):
        assert rank_blocks(part, specs) == want
    n = cfg.num_heads * cfg.resolved_head_dim // G
    for key in ("m", "v"):
        full = state["opt_state"][key]["layers"][0]
        cut = got["opt_state"][key]["layers"][0]
        assert torch.equal(cut["attn"]["wq"],
                           full["attn"]["wq"][..., 2 * n:3 * n])
        assert torch.equal(cut["attn"]["wo"],
                           full["attn"]["wo"][:, 2 * n:3 * n])
        f = cfg.d_ff // G
        assert torch.equal(cut["ffn"]["w_up"],
                           full["ffn"]["w_up"][..., 2 * f:3 * f])
        assert torch.equal(cut["ffn"]["w_down"],
                           full["ffn"]["w_down"][:, 2 * f:3 * f])
        assert cut["norm1"]["scale"] is full["norm1"]["scale"]
        v = cfg.vocab_size // G
        assert torch.equal(got["opt_state"][key]["embed"],
                           state["opt_state"][key]["embed"][2 * v:3 * v])


# ---------------------------------------------------------------------------
# Attention by heads and experts by expert on each rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rank_reference(tmp_path_factory):
    """The subprocess's ``ranks`` entry, with the ``RANK_SHARED`` models'
    one-device logits, loss, gradients and their global norm taken from
    its ``encdec`` entry, or its ``recurrent`` and ``recurrent_grad``
    ones (the same reduced config, params and batch)."""
    ranks = jax_reference.reference(tmp_path_factory, entry="ranks")
    entries = {entry: jax_reference.reference(tmp_path_factory, entry=entry)
               for pair in jax_reference.RANK_SHARED.values()
               for entry in pair}
    for name, (fwd, grad) in jax_reference.RANK_SHARED.items():
        arch = jax_reference.RANK_MODELS[name]["arch"]
        want = entries[grad][arch]
        norm = np.sqrt(sum(np.square(g, dtype=np.float64).sum()
                           for g in want["grads"]))
        ranks[name].update(logits=entries[fwd][arch]["logits"],
                           loss=want["loss"],
                           grads=want["grads"], grad_norm=float(norm))
    return ranks


@pytest.mark.parametrize("name,backend", [
    (name, backend) for name, (backends, _) in RANK_MODELS.items()
    for backend in backends])
def test_rank_model_prefill_matches_reference(ranks, rank_reference, name,
                                              backend):
    """Each rank's prefill on its blocks (``uniform-fused-1d``) within
    2e-3 of the reference's one-device forward, the same bits on every
    rank."""
    logits = [res["model", name]["prefill"][backend][0] for res in ranks]
    np.testing.assert_allclose(logits[0], rank_reference[name]["logits"],
                               **MODEL_TOL)
    for other in logits[1:]:
        np.testing.assert_array_equal(other, logits[0])


@pytest.mark.parametrize("name", ODD)
def test_rank_model_odd_prefill_matches_reference(ranks, rank_reference,
                                                  name):
    """At a length the group does not divide (30 encoder frames; a VLM's
    8 + 22 positions joined), each rank's prefill with the residual
    replicated within 2e-3 of the reference's one-device forward, the
    same bits on every rank."""
    logits = [res["model", name]["prefill_odd"][0] for res in ranks]
    np.testing.assert_allclose(logits[0], rank_reference[name]["logits_odd"],
                               **MODEL_TOL)
    for other in logits[1:]:
        np.testing.assert_array_equal(other, logits[0])


def _engine_cases() -> list:
    """(model, cache, encoder length): each rank model's engine at the
    cache the rule time-slices and at one it keeps whole, an
    encoder-decoder's with its cross cache whole, and with it
    time-sliced at the first."""
    cases = []
    for name in RANK_MODELS:
        encs = _encs(_rank_cfg(name))
        cases += [(name, cache, encs[0]) for cache in ("cache", "whole")]
        cases += [(name, "cache", enc) for enc in encs[1:]]
    return cases


@pytest.mark.parametrize("name,cache,enc", _engine_cases())
def test_rank_model_engine_matches_one_process(ranks, rank_params, name,
                                               cache, enc):
    """Every rank's engine gives the tokens of the port's engine on the
    whole model here, with the cache the rule time-slices (the rank's
    quarter of the attention or latent cache) and with one it keeps
    whole; an encoder-decoder's with its cross cache whole (16 frames)
    and time-sliced (1024)."""
    cfg = _rank_cfg(name)
    cache_len = ENGINE[cache]
    want = _one_process_tokens(rank_params[name], cache_len, cfg, enc)
    sliced = cache == "cache"
    for res in ranks:
        tokens, positions = _positions(res, name, cache_len, enc)
        if name != "xlstm":  # the SSM family has no attention cache
            assert positions == (cache_len // G if sliced else cache_len)
        assert tokens == want


@pytest.mark.parametrize("name,mode,length,enc", [
    (name, mode, length, enc) for name in RANK_MODELS
    for enc in _encs(_rank_cfg(name)) for mode in DECODE_ATTN
    for length in ENGINE["prompts"]])
def test_rank_engine_matches_reference_engine(ranks, rank_reference, name,
                                              mode, length, enc):
    """Every rank's ``DecodeEngine`` in either decode attention, at a
    cache the rule time-slices, gives the tokens of the reference's
    one-device engine, for a prompt length 4 divides and one it does
    not; an encoder-decoder's at an encoder length whose cross cache the
    rule keeps whole and one it time-slices."""
    want = rank_reference[name]["engine"][length, enc]
    assert all(len(t) == ENGINE["new"] for t in want)
    for res in ranks:
        tokens, _ = res["model", name]["engine"][mode, ENGINE["cache"],
                                                 length, enc]
        assert tokens == want


@pytest.mark.parametrize("name,cache,enc", _engine_cases())
def test_rank_cache_leaves_follow_the_reference_rule(ranks, name, cache,
                                                     enc):
    """Each leaf of a rank's engine cache has the shape of its block by
    the reference's ``cache_leaf_spec`` on a model-only mesh of 4 (the
    whole cache's on the meta device), in either decode attention; a
    time slice carries its record (``"time_slice"``, an encoder-decoder's
    cross cache ``"cross_slice"``); a recurrent layer's state (which the
    rule keeps whole at these widths) has none."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import SLICE_RECORDS
    from repro_torch.parallel.sharding import cache_leaf_spec, shard_shape

    mesh = Mesh(("model",), (G,))
    cache_len = ENGINE[cache]
    whole = build_model(_rank_cfg(name)).init_cache(
        ENGINE["batch"], cache_len, enc_len=enc, device="meta")
    want = [{k: shard_shape(cache_leaf_spec(v.shape, mesh), v.shape, mesh)
             for k, v in c.items()} for c in whole]
    sliced = cache == "cache"
    cross = enc >= 1024
    runs = [(mode, cache_len, PROMPT, enc) for mode in DECODE_ATTN
            if sliced or mode == "shard_map"]
    for res in ranks:
        for run in runs:
            got = res["model", name]["engine"][run][1]
            for leaves_got, leaves_want in zip(got, want, strict=True):
                attention = "k" in leaves_got or "c_kv" in leaves_got
                assert ("time_slice" in leaves_got) is (sliced and attention)
                assert ("cross_slice" in leaves_got) is cross
                leaves_got = {k: v for k, v in leaves_got.items()
                              if k not in SLICE_RECORDS}
                assert leaves_got == leaves_want
                for k, v in leaves_got.items():
                    if k.startswith("cross_"):
                        assert v[2] == (enc // G if cross else enc)
                    elif sliced and attention:
                        assert v[2] == cache_len // G


@pytest.mark.parametrize("name", list(RANK_MODELS))
def test_rank_model_grads_match_reference(ranks, rank_reference, name):
    """Each rank's loss and gradient blocks against the reference's jitted
    loss and gradients, cut by the same rule, at 2e-3."""
    from repro_torch.tree import leaves, unflatten

    want = rank_reference[name]
    model = build_model(_rank_cfg(name))
    specs = model.rank_specs(G)
    grads = unflatten(model.init(device="meta"), want["grads"])
    for r, res in enumerate(ranks):
        got = res["model", name]
        np.testing.assert_allclose(got["loss"], want["loss"], **MODEL_TOL)
        cut = leaves(shard_params(grads, specs, r, G))
        assert len(got["grads"]) == len(cut)
        for a, b in zip(got["grads"], cut):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, **MODEL_TOL)


@pytest.mark.parametrize("name", list(RANK_MODELS))
def test_rank_model_step_matches_reference(ranks, rank_reference, name):
    """One train step's loss and ``grad_norm`` on every rank against the
    reference's (its jitted loss and its ``global_norm`` of the
    gradients), the same bits on every rank."""
    want = rank_reference[name]
    first = ranks[0]["model", name]["metrics"]
    for res in ranks:
        got = res["model", name]["metrics"]
        assert got == first
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], **MODEL_TOL,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# MLA with heads the group does not divide
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_reference():
    """The reference's ``mla_apply`` on the MLA layer case's x, the
    gradients of sum(y * dy), and ``mla_decode`` over x's first
    positions on a whole cache of each of ``MLA_CACHES`` (numpy; each
    jitted once)."""
    from repro.models import mla as jax_mla

    cfg = _mla_cfg(jax_get_config).mla
    params, x, dy = _mla_operands()
    b, s, _ = x.shape
    positions = np.broadcast_to(np.arange(s), (b, s))

    def forward(p):
        def apply(p):
            return jax_mla.mla_apply(p, x, MLA["heads"], cfg,
                                     positions=positions)

        y, vjp = jax.vjp(apply, p)
        return y, vjp(dy)[0]

    def decode(p, cache):
        ys = []
        for t in range(MLA["decode"]):
            y_t, cache = jax_mla.mla_decode(p, x[:, t:t + 1], cache, t,
                                            MLA["heads"], cfg)
            ys.append(y_t)
        return jax.numpy.concatenate(ys, 1)

    y, grads = jax.jit(forward)(params)
    return dict(y=np.asarray(y), grads=jax.tree.map(np.asarray, grads),
                decode={n: np.asarray(jax.jit(decode)(
                    params, jax_mla.mla_init_cache(b, n, cfg,
                                                   jax.numpy.float32)))
                        for n in MLA_CACHES})


def test_rank_mla_blocks_straddle_heads(ranks):
    """Each rank holds a column block of ``wq``, ``w_uk`` and ``w_uv`` that
    is no whole number of the 6 heads (the rule keeps a cut wherever 4
    divides the dimension), ``wo``'s row block, and the latent and
    rope-key projections whole."""
    cfg = _mla_cfg(get_config).mla
    mla_params = _mla_operands()[0]
    widths = {"wq": cfg.nope_head_dim + cfg.rope_head_dim,
              "w_uk": cfg.nope_head_dim, "w_uv": cfg.v_head_dim}
    for res in ranks:
        blocks = res["mla"]["blocks"]
        for key, width in widths.items():
            cols = blocks[key][1]
            assert cols * G == mla_params[key].shape[1]
            assert cols % width  # a share of a head
        assert blocks["wo"][0] * G == mla_params["wo"].shape[0]
        for key in ("w_dkv", "w_kr"):
            assert blocks[key] == mla_params[key].shape


@pytest.mark.parametrize("layout", ["replicated", "seq"])
def test_rank_mla_indivisible_heads_match_reference(ranks, mla_reference,
                                                    layout):
    """MLA with 6 heads on 4 ranks: each rank gathers its column blocks to
    whole heads, computes every head and multiplies by ``wo``'s row block
    the columns it owns; the group's sum (all-reduced on the replicated
    input, reduce-scattered to the rank's block of the sequence) within
    1e-5 of the reference's ``mla_apply``."""
    s = mla_reference["y"].shape[1] // G
    for r, res in enumerate(ranks):
        want = mla_reference["y"]
        if layout == "seq":
            want = want[:, r * s:(r + 1) * s]
        np.testing.assert_allclose(res["mla"][layout], want, rtol=1e-5,
                                   atol=1e-5)


def test_rank_mla_indivisible_heads_grads_match_reference(
        ranks, mla_reference):
    """Each rank's gradients of its MLA blocks (the sequence-cut input)
    against the reference's ``jax.grad``, cut by the same rule, at 1e-5
    of the largest: a whole latent projection's summed over the ranks, a
    straddling column block's its own."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import mla
    from repro_torch.parallel.sharding import fix_param_specs

    shapes = {k: torch.empty(v.shape, device="meta")
              for k, v in mla_reference["grads"].items()}
    specs = fix_param_specs(mla.mla_param_specs(), shapes,
                            Mesh(("model",), (G,)))
    for r, res in enumerate(ranks):
        want = shard_params(mla_reference["grads"], specs, r, G)
        for key, got in res["mla"]["grads"].items():
            scale = np.abs(want[key]).max()
            np.testing.assert_allclose(got, want[key], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=key)


@pytest.mark.parametrize("cache_len", MLA_CACHES)
def test_rank_mla_indivisible_heads_decode_matches_reference(
        ranks, mla_reference, cache_len):
    """``mla_decode`` per rank with 6 heads on 4, over a latent cache the
    rule keeps whole (64) and one whose time axis it cuts (1024: the
    rank's 256 positions, gathered each step), within 1e-5 of the
    reference's on a whole cache, every step."""
    for res in ranks:
        got, here = res["mla"]["decode"][cache_len]
        assert here == (cache_len // G if cache_len >= 1024 else cache_len)
        np.testing.assert_allclose(got, mla_reference["decode"][cache_len],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The recurrent layers with their decode state cut by the rule
# ---------------------------------------------------------------------------

def _recurrent_fns(kind: str, d_model: int, heads: int, cfg):
    """The reference's apply (p, x), whole start state (batch) and decode
    (p, x, cache) of a ``RECURRENT`` layer."""
    from repro.models import mamba as jax_mamba
    from repro.models import xlstm as jax_xlstm

    f32 = jax.numpy.float32
    if kind == "mamba":
        return (lambda p, x: jax_mamba.mamba_apply(p, x, cfg),
                lambda b: jax_mamba.mamba_init_cache(b, d_model, cfg, f32),
                lambda p, x, c: jax_mamba.mamba_decode(p, x, c, cfg))
    if kind == "mlstm":
        return (lambda p, x: jax_xlstm.mlstm_apply(p, x, heads, cfg),
                lambda b: jax_xlstm.mlstm_init_cache(b, d_model, heads, cfg),
                lambda p, x, c: jax_xlstm.mlstm_decode(p, x, c, heads, cfg))
    return (lambda p, x: jax_xlstm.slstm_apply(p, x, cfg),
            lambda b: jax_xlstm.slstm_init_cache(b, d_model, cfg),
            lambda p, x, c: jax_xlstm.slstm_decode(p, x, c, cfg))


@pytest.fixture(scope="module")
def recurrent_reference():
    """For each ``RECURRENT`` layer: the reference's apply on its x, the
    gradients of sum(y * dy), and its decode over x's first positions
    from the whole start state, with the state after (numpy; one jitted
    function a layer)."""
    out = {}
    for kind in RECURRENT["kinds"]:
        layer = jax_reference.recurrent_layer_config(jax_get_config, kind)
        params, x, dy = jax_reference.recurrent_operands(kind, *layer)
        apply, start, step = _recurrent_fns(kind, *layer)

        def run(p, cache, apply=apply, step=step, x=x, dy=dy):
            y, vjp = jax.vjp(lambda q: apply(q, x), p)
            ys = []
            for t in range(RECURRENT["decode"]):
                y_t, cache = step(p, x[:, t:t + 1], cache)
                ys.append(y_t)
            return y, vjp(dy)[0], jax.numpy.concatenate(ys, 1), cache

        y, grads, ys, cache = jax.jit(run)(params, start(x.shape[0]))
        out[kind] = dict(y=np.asarray(y),
                         grads=jax.tree.map(np.asarray, grads),
                         decode=np.asarray(ys),
                         cache=jax.tree.map(np.asarray, cache))
    return out


def _recurrent_specs(kind: str, tree):
    """The rule's specs of a ``RECURRENT`` layer's leaves (``tree``'s
    shapes) on a model-only mesh of 4."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import mamba, xlstm
    from repro_torch.parallel.sharding import fix_param_specs

    specs = {"mamba": mamba.mamba_param_specs,
             "mlstm": xlstm.mlstm_param_specs,
             "slstm": xlstm.slstm_param_specs}[kind]()
    shapes = {k: torch.empty(v.shape, device="meta") for k, v in tree.items()}
    return fix_param_specs(specs, shapes, Mesh(("model",), (G,)))


def _close(got, want, err_msg=""):
    """Within 1e-5 of the largest |want|, as the MLA case's gradients."""
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=err_msg)


@pytest.mark.parametrize("layout", ["replicated", "seq"])
@pytest.mark.parametrize("kind", RECURRENT["kinds"])
def test_rank_recurrent_layer_matches_reference(ranks, recurrent_reference,
                                                kind, layout):
    """A Mamba layer of d_inner 1024, an mLSTM of 4 heads of 1024 and an
    sLSTM of d_inner 1024 on each rank's blocks (every d_inner leaf cut,
    the mLSTM's ``w_if`` and the sLSTM's ``r_gates`` whole): the group's
    sum on the replicated input (all-reduced) and on the rank's sequence
    block (reduce-scattered) within 1e-5 of the largest output of the
    reference's layer."""
    want = recurrent_reference[kind]["y"]
    s = want.shape[1] // G
    for r, res in enumerate(ranks):
        got = res["recurrent", kind][layout]
        _close(got, want if layout == "replicated"
               else want[:, r * s:(r + 1) * s])


@pytest.mark.parametrize("kind", RECURRENT["kinds"])
def test_rank_recurrent_layer_grads_match_reference(ranks,
                                                    recurrent_reference,
                                                    kind):
    """Each rank's blocks are the rule's (``shard_shape`` on a model-only
    mesh of 4; the whole leaves whole), and their gradients (the
    sequence-cut input) against the reference's ``jax.grad`` cut by the
    same rule, within 1e-5 of the largest: a whole leaf's summed over the
    ranks, a block's its own."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import block_dim, shard_shape

    grads = recurrent_reference[kind]["grads"]
    specs = _recurrent_specs(kind, grads)
    mesh = Mesh(("model",), (G,))
    whole = {k for k, sp in specs.items() if block_dim(sp) is None}
    assert whole == {"mlstm": {"w_if"}, "slstm": {"r_gates"}}.get(kind,
                                                                  set())
    for r, res in enumerate(ranks):
        got = res["recurrent", kind]
        assert got["blocks"] == {k: shard_shape(specs[k], v.shape, mesh)
                                 for k, v in grads.items()}
        want = shard_params(grads, specs, r, G)
        for key, grad in got["grads"].items():
            _close(grad, want[key], err_msg=key)


@pytest.mark.parametrize("kind", RECURRENT["kinds"])
def test_rank_recurrent_layer_decode_matches_reference(ranks,
                                                       recurrent_reference,
                                                       kind):
    """The decode per rank from the start state, each leaf the rank's
    block by ``cache_leaf_spec`` (Mamba's conv window and ssm state and
    the sLSTM's state on d_inner, the mLSTM's ``c`` on its key dim and
    ``n`` on hd; the mLSTM's ``m`` whole): every step's output within
    1e-5 of the largest of the reference's on a whole state, the state
    after it the rank's block of the reference's, and a whole leaf the
    same bits on every rank."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import block_dim, cache_leaf_spec

    want = recurrent_reference[kind]
    mesh = Mesh(("model",), (G,))
    for r, res in enumerate(ranks):
        got = res["recurrent", kind]
        _close(got["decode"], want["decode"])
        for key, leaf in got["cache"].items():
            whole = want["cache"][key]
            spec = cache_leaf_spec((1, *whole.shape), mesh)
            dim = block_dim(spec)
            assert (dim is None) is (kind == "mlstm" and key == "m")
            if kind == "mlstm" and key == "c":
                assert dim == 3  # c[b, h, d, e]'s key dim d
            if dim is None:
                np.testing.assert_array_equal(
                    leaf, ranks[0]["recurrent", kind]["cache"][key])
            else:
                n = whole.shape[dim - 1] // G
                whole = whole.take(range(r * n, (r + 1) * n), axis=dim - 1)
            _close(leaf, whole, err_msg=key)


@pytest.mark.parametrize("name", RECURRENT_MODELS)
def test_rank_recurrent_state_equal_on_every_rank(ranks, name):
    """After each engine run of the reduced Jamba and xLSTM per rank, the
    recurrent layers' decode state, which the rule keeps whole at their
    widths, holds the same bits on every rank."""
    first = ranks[0]["model", name]["states"]
    assert first and all(first.values())
    for res in ranks[1:]:
        states = res["model", name]["states"]
        assert states.keys() == first.keys()
        for run, leaves in states.items():
            for key, leaf in leaves.items():
                np.testing.assert_array_equal(leaf, first[run][key],
                                              err_msg=str((run, key)))


def test_rank_gather_replicated_grad_matches_logical(ranks):
    """``gather_replicated`` joins the blocks in rank order, and its
    gradient is this rank's block of the replicated cotangent, as the
    logical step (the blocks joined once, one computation after) gives;
    ``all_gather``'s reduce-scatter would give g times that."""
    x, dy = _gather_operands()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = xt.movedim(0, 1).flatten(1)
    (want,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    for r, res in enumerate(ranks):
        out, grad = res["gather_grad"]["gather_replicated"]
        np.testing.assert_array_equal(out, y.detach().numpy())
        np.testing.assert_allclose(grad, want[r].numpy(), rtol=1e-6,
                                   atol=1e-6)
        _, summed = res["gather_grad"]["all_gather"]
        np.testing.assert_allclose(summed, G * want[r].numpy(), rtol=1e-6,
                                   atol=1e-6)


def _spec_leaves(specs) -> list:
    """The specs of a tree of ``P`` in ``leaves`` order."""
    from repro_torch.parallel.sharding import P

    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [x for v in specs for x in _spec_leaves(v)]


# A rank's parameter bytes (bf16, the MoE router fp32) and its decode
# cache's bytes at 4 requests of 2048 positions (an encoder-decoder's with
# 1024 encoder positions), on 4 ranks at full width (chip_smoke.py holds
# the card's to the rule's, which these hold).
RANK_BYTES = {"tinyllama-1.1b": (550_162_432, 46_137_344),
              "deepseek-v2-lite-16b": (8_165_486_592, 63_700_992),
              "seamless-m4t-large-v2": (1_017_880_576, 301_989_888),
              "internvl2-76b": (35_331_260_416, 671_088_640),
              "jamba-1.5-large-398b": (199_304_626_176, 147_750_912),
              "xlstm-1.3b": (3_757_858_816, 705_727_104)}
RANK_ENC_LEN = 1024


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b",
                                  "smollm-360m", "arctic-480b",
                                  "seamless-m4t-large-v2", "internvl2-76b",
                                  "jamba-1.5-large-398b", "xlstm-1.3b"])
def test_rank_param_bytes_match_shard_shape(arch):
    """At full width (on the meta device), each rank's parameter bytes:
    ``shard_shape`` over ``fix_param_specs`` of ``param_specs`` on a
    model-only mesh of 4 for the embedding and unembedding and the leaves
    of a layer's attention, FFN and recurrent mixer (the encoder's
    layers' too), and the whole bytes of every other leaf (the norms, the
    router, ``enc_norm``, ``frontend_proj``); TinyLlama-1.1B's,
    DeepSeek-V2-Lite-16B's, SeamlessM4T-v2's, InternVL2-76B's,
    Jamba-1.5-Large's and xLSTM-1.3B's to the byte."""
    import math

    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import fix_param_specs, shard_shape
    from repro_torch.tree import leaves

    model = build_model(get_config(arch))
    state = model.init(device="meta")
    mesh = Mesh(("model",), (G,))
    fixed = fix_param_specs(model.param_specs(), state, mesh)

    def nbytes(shape, t):
        return math.prod(shape) * t.element_size()

    def layer(slot, slot_specs):
        total = 0
        for key, sub in slot.items():
            cut = key in ("attn", "cross", "ffn", "mixer")
            for t, sp in zip(leaves(sub), _spec_leaves(slot_specs[key]),
                             strict=True):
                total += nbytes(shard_shape(sp, t.shape, mesh) if cut
                                else t.shape, t)
        return total

    want = sum(nbytes(shard_shape(fixed[k], t.shape, mesh)
                      if k in ("embed", "unembed") else t.shape, t)
               for k, v in state.items() if k not in ("layers", "encoder")
               for t in leaves(v))
    for slot, slot_specs in zip(state["layers"], fixed["layers"]):
        want += layer(slot, slot_specs)
    if "encoder" in state:
        want += layer(state["encoder"], fixed["encoder"])
    whole = sum(nbytes(t.shape, t) for t in leaves(state))
    specs = model.rank_specs(G)
    for r in range(G):
        got = sum(t.numel() * t.element_size()
                  for t in leaves(shard_params(state, specs, r, G)))
        assert got == want
    assert want < whole
    assert want == RANK_BYTES.get(arch, (want,))[0]


@pytest.mark.parametrize("arch", list(RANK_BYTES))
def test_rank_cache_bytes_at_full_width(arch):
    """At full width (on the meta device), a rank's decode cache for 4
    requests of 2048 positions (and an encoder-decoder's cross K/V of
    1024 encoder positions): its leaves' bytes, each the rank's block by
    ``cache_leaf_spec`` on a model-only mesh of 4 (an attention cache's
    time slice, a recurrent state's block of d_inner or of the mLSTM's
    key dim), to the byte; every leaf is cut but the mLSTM's running
    maxima ``m``."""
    import math

    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import (block_dim, cache_leaf_spec,
                                               shard_shape)

    mesh = Mesh(("model",), (G,))
    cfg = get_config(arch)
    whole = build_model(cfg).init_cache(
        4, 2048, enc_len=RANK_ENC_LEN if cfg.encdec else 0, device="meta")
    got = sum(math.prod(shard_shape(cache_leaf_spec(t.shape, mesh), t.shape,
                                    mesh)) * t.element_size()
              for c in whole for t in c.values())
    assert got == RANK_BYTES[arch][1]
    kept = [(k, t.numel() * t.element_size()) for c in whole
            for k, t in c.items() if block_dim(cache_leaf_spec(t.shape,
                                                               mesh)) is None]
    assert {k for k, _ in kept} <= {"m"}
    kept_bytes = sum(n for _, n in kept)
    assert (got - kept_bytes) * G == sum(
        t.numel() * t.element_size() for c in whole
        for t in c.values()) - kept_bytes


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-76b",
                                  "jamba-1.5-large-398b", "xlstm-1.3b"])
def test_encdec_vlm_hybrid_and_ssm_rank_specs_cut_by_the_rule(arch):
    """The encoder-decoder, VLM, hybrid and SSM families run per rank:
    their ``rank_specs`` are the reference's ``param_specs`` fixed on a
    model-only mesh of 4 for the decoder's and the encoder's attention,
    FFN and recurrent mixer leaves (each cut on the model axis where 4
    divides it, but the mLSTM's ``w_if`` and the sLSTM's ``r_gates``,
    whole in the reference), the cross-attention's and the vocabulary's,
    with ``enc_norm``, ``frontend_proj`` and the norms whole."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import block_dim, fix_param_specs

    def whole(tree):
        return all(block_dim(sp) is None for sp in _spec_leaves(tree))

    model = build_model(get_config(arch).reduced())
    specs = model.rank_specs(G)
    fixed = fix_param_specs(model.param_specs(), model.init(device="meta"),
                            Mesh(("model",), (G,)))
    raw = model.param_specs()
    stacks = [*zip(specs["layers"], fixed["layers"], raw["layers"])]
    if "encoder" in specs:
        stacks.append((specs["encoder"], fixed["encoder"], raw["encoder"]))
        assert whole(specs["enc_norm"])
    elif "frontend_proj" in specs:
        assert whole(specs["frontend_proj"])
    mixers = 0
    for got, want, ref in stacks:
        for key in got:
            if key in ("attn", "cross", "ffn", "mixer"):
                assert got[key] == want[key]
                # Cut wherever the reference's spec names the model axis
                # (4 divides every such dim here); whole where it does
                # not: the router, the mLSTM's w_if, the sLSTM's r_gates.
                for sp, sp_ref in zip(_spec_leaves(got[key]),
                                      _spec_leaves(ref[key]), strict=True):
                    assert (block_dim(sp) is None) is (
                        block_dim(sp_ref) is None)
                if key == "mixer":
                    mixers += 1
                    kept = {k for k, sp in got[key].items()
                            if block_dim(sp) is None}
                    assert kept == {"w_if", "r_gates"} & set(got[key])
            else:
                assert whole(got[key])
    assert mixers == (len(stacks) if arch == "xlstm-1.3b" else
                      len(stacks) - 1 if arch.startswith("jamba") else 0)
    for key in ("embed", "unembed"):
        assert specs[key] == fixed[key] and block_dim(specs[key]) is not None
