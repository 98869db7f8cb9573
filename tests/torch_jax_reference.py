"""The reference's jax grid engine, run once for the port's parity tests.

``repro.autotune`` does not import under jax 0.9.0: ``jaxgrid.py`` imports
``jax.experimental.enable_x64``, which that release dropped while keeping
``jax.enable_x64``.  This script aliases the one to the other in its own
process before importing the reference, and changes nothing under
``src/repro``: the reference's own tests run without the alias and go on
failing as before.

Run as a script (``python tests/torch_jax_reference.py ERR.txt
FIRST.pkl`` and one more pickle for each of ``LATER``) it evaluates, with ``JAX_PLATFORMS=cpu``:

  * ``dense``: the uniform grid (every raw output) of ``DENSE`` on the
    first ``N_GRID_MACHINES`` of ``machine_grid()``, and ``d sum(valid
    totals) / d (link_bw, s_half)`` by ``jax.grad``;
  * ``ragged``: the ragged grid of ``RAGGED`` on ``machine_grid(groups=
    RAGGED_GROUPS)``;
  * ``tau``: ``calibrate_tau`` and ``calibrate_tau_reference`` on MI300X
    over Table I;
  * ``shortlist``: ``shortlist(backend="jax")`` of ``SHORTLIST_GEMMS``;
  * ``fit``: ``synthesize_records`` from a perturbed MI300X and
    ``fit_machine`` on them (the reference's recovery test);
  * ``moe``: ``serial_a2a_ffn`` and ``ficco_a2a_ffn`` (each case of
    ``MOE_CASES``) under ``shard_map`` on ``MOE["g"]`` devices, on the
    operands :func:`moe_operands` makes;
  * ``adapt``: the reference's ``AdaptiveTier`` through
    :func:`adapt_script` (the port's tests run the same script);
  * ``decode_attn``: ``shard_map_attn_decode`` on a mesh of
    ``DECODE_ATTN["g"]`` devices on the ``model`` axis, at each of
    ``DECODE_ATTN_POS``, on the operands :func:`decode_attn_operands`
    makes;
  * ``moe_grad``: for each of ``MOE_TRAIN["archs"]`` (reduced, fp32), the
    params, ``jax.value_and_grad`` of ``model.loss`` on ``SyntheticLM``'s
    batch 0, and ``MOE_TRAIN["steps"]`` steps of the jitted train step
    (``OCFG``) from ``init_train_state``: each step's metrics and the
    last step's state;
  * ``encdec``: for each of ``ENCDEC["archs"]`` (reduced, fp32), the
    params, batch 0, the forward's logits and aux, the loss and its
    gradients, and ``ENCDEC["decode"]`` cached decode steps over the
    batch's first tokens (an encoder-decoder's cross K/V filled by
    ``prefill_cross`` from the batch's frames; a VLM's on text);
  * ``recurrent``: the same for each of ``RECURRENT["archs"]`` (the
    hybrid and SSM families, reduced, fp32) without the gradients, plus
    the tokens of ``DecodeEngine.run`` on :func:`recurrent_requests`,
    twice on one engine (the second run shows ROADMAP R7); for each of
    ``RECURRENT["bf16"]`` also the forward and decode in bf16 (``bf16``);
  * ``counts``: ``count_params`` of every arch in the registry at full
    width;
  * ``recurrent_grad``: ``moe_grad``'s entry for each of
    ``RECURRENT_TRAIN["archs"]`` (the hybrid and SSM families);
  * ``collectives``: ``parse_collectives`` of the compiled forward of each
    of the six schedules (``SCHEDULE_FNS``) under ``shard_map`` on
    ``COLLECTIVES["g"]`` devices, at :func:`schedule_operands`' shapes,
    and of ``serial_a2a_ffn`` on :func:`moe_operands`' (``"serial_a2a"``):
    (bytes by kind, count by kind); under ``"outputs"`` each schedule's
    output on those operands in float32 and in bfloat16 (as float32
    numpy, by dtype name, then schedule); and under ``"reduce"``
    ``lax.psum`` and ``lax.pmax`` over the axis of
    :func:`reduce_operands`' blocks (``"psum"``, ``"pmax"``);
  * ``dryrun``: the dry-run's specs, each tree as ``{path: tuple(spec)}``
    (:func:`spec_paths`): every arch's ``param_specs()``, and on each of
    ``DRYRUN["meshes"]`` (stand-ins with a ``shape``) its
    ``fix_param_specs`` and the ``cache_specs`` of each of
    ``DRYRUN["caches"]`` through ``prepared_config``; and for each of
    ``DRYRUN["compiled"]`` (reduced) and each step kind at ``DRYRUN``'s
    seq and batch on the forced devices as (data 2, model 2), the
    compiled step's ``argument_size_in_bytes`` and ``parse_collectives``
    (bytes by kind, count by kind);
  * ``examples``: the reference's ``examples/serve_batched.py`` run as it
    stands (``runpy``, its output swallowed): its params
    (``PRNGKey(0)``) and each request's tokens;
  * ``ranks``: for each of ``RANK_MODELS`` (:func:`rank_config`, fp32),
    from ``PRNGKey(0)``, the one-device forward's logits on SyntheticLM's
    batch 0 at ``RANK_TRAIN``'s shape (its tokens, and a VLM's prefix or
    an encoder-decoder's frames), and the loss, the gradients and their
    global norm there (a train step's loss and ``grad_norm``), in one
    jitted function (but for ``RANK_SHARED``, whose earlier entries hold
    them); for each of ``RANK_ODD_PREFILL`` also the forward's
    logits at ``RANK_ODD``'s shape (``"logits_odd"``); and under
    ``"dense"`` the same for the reduced TinyLlama at ``RANK_ODD``'s
    shape, whose length a group of 4 does not divide; for each of them,
    the tokens of the one-device ``DecodeEngine`` (``RANK_ENGINE``) for
    each prompt length (a hybrid's or SSM's from a fresh cache each),
    an encoder-decoder's at each of ``RANK_ENC``'s encoder lengths, its
    cross K/V filled by ``prefill_cross`` from :func:`engine_frames`.

The first eight entries go to ``FIRST.pkl``; the later ones (the whole
models, the slower half) follow, each in a pickle of its own, in
``LATER``'s order, so a test waits only for what it reads; except
``collectives``, a few seconds, which is written before all the others.

The script runs with ``MOE["g"]`` forced host devices
(``--xla_force_host_platform_device_count``); the other entries run on
the first, as they would on one.

:func:`start` launches the script once per test session, whatever the
number of pytest-xdist workers (the first caller, under a lock in the
session's shared temporary directory), in the background: the port's
own tests run meanwhile.  :func:`reference` waits for its pickle.
"""

import atexit
import dataclasses
import fcntl
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# Shared by the script and the tests: the same seeds and sizes on both
# sides.  The grids run on the reference's eight machine-grid machines
# (the port's machine_grid()[:8]: MI300X and TPU v5e, groups 8 and 16,
# full mesh and torus), so the padded pipeline runs to g_max 16.
DENSE = dict(n=300, seed=11)
RAGGED = dict(n=200, steps=4, seed=12)
N_GRID_MACHINES = 8
# The ragged grid runs on the group-8 machines (g_max 8: a shorter
# compile); the dense grid covers the padding to 16.
RAGGED_GROUPS = (8,)
FIT_TRUE = {"link_bw_scale": 0.8, "s_half": 3.2e6}
FIT_STEPS = 300
SHORTLIST_GEMMS = ((8192, 4096, 4096, 2), (2048, 5632, 2048, 2),
                   (65536, 8192, 1024, 1))
# The expert-parallel dispatch: g ranks, E global experts, capacity C,
# widths D and F.  C = 12 takes the uniform cuts of 4 (one per rank) and
# of 3, and the explicit sizes below (one empty chunk).
MOE = dict(g=4, e=8, c=12, d=16, f=32, seed=21)
MOE_SIZES = (5, 0, 4, 3)
MOE_SKEW = 2.0  # StepProfile.skewed(g, MOE_SKEW)
MOE_CASES = ("serial", "default", "chunks3", "reverse", "skewed", "sizes")
# The adaptive tier's scripted run: N requests of the drifting stream at
# one request per DT seconds of an injected clock, every UNIFORM_EVERY-th
# a uniform pick of the next ADAPT_UNIFORM GEMM (the machine fit's
# records), a refit_now() before request REFIT_AT, and every pick
# measured while the budget (BURST, no refill) lasts.
ADAPT = dict(n=200, seed=0, drift_every=50, dt=0.25, uniform_every=5,
             refit_at=100, burst=48.0, sigma=10.0)
ADAPT_UNIFORM = tuple((4096 * (i + 1), 8192, 8192, 2) for i in range(8))
# Decode attention over a time-sharded cache: B, S, H, KV, D; pos in the
# first, a middle and the last of the g time shards.
DECODE_ATTN = dict(g=4, b=2, s=1024, h=8, kv=2, d=16, seed=31)
DECODE_ATTN_POS = (5, 600, 1023)
# Training the MoE family, and the encoder-decoder and VLM paths: the
# reduced configs at seq x batch, SyntheticLM(seed); the optimizer of
# tests/test_torch_train.py.
MOE_TRAIN = dict(archs=("deepseek-v2-lite-16b", "arctic-480b"), seq=32,
                 batch=2, steps=2, seed=0)
OCFG = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
ENCDEC = dict(archs=("seamless-m4t-large-v2", "internvl2-76b"), seq=32,
              batch=2, decode=8, cache=16, seed=0)
# Serving the hybrid and SSM families: as ENCDEC, and an engine of
# `batch` requests of `prompt` tokens and `new` new ones; the `bf16` archs
# also in bfloat16 (forward and decode).
RECURRENT = dict(archs=("jamba-1.5-large-398b", "xlstm-1.3b"), seq=32,
                 batch=2, decode=8, cache=16, seed=0, prompt=5, new=4,
                 bf16=("xlstm-1.3b",))
# Training the hybrid and SSM families: as MOE_TRAIN.
RECURRENT_TRAIN = dict(MOE_TRAIN, archs=RECURRENT["archs"])
# The schedules' collectives: g ranks of m_s rows, K columns, n_local
# output columns each (row chunks of m_s / g, K slices of K / g); the
# reductions' blocks of `reduce` each.
COLLECTIVES = dict(g=4, m_s=16, k=32, n_local=8, seed=41, reduce=(3, 5))
# The dry-run's spec stand-ins and compiled steps.
DRYRUN = dict(meshes=({"data": 16, "model": 16},
                      {"pod": 2, "data": 16, "model": 16},
                      {"data": 2, "model": 2}),
              caches=("decode_32k", "long_500k"),
              compiled=("tinyllama-1.1b", "xlstm-1.3b"),
              kinds=("prefill", "train"), seq=64, batch=8)
# The entries after the first eight, each in a pickle of its own, in the
# order the script writes them after the first eight (``collectives``
# goes before those), each holding a pytest-xdist worker that waits for
# it (seconds alone, on one run: counts 5.8, collectives 1.2, examples
# 5.6, recurrent_grad 18.3, recurrent 8.9, dryrun 15.8, moe_grad 17.1;
# on a later run encdec 16.4 and ranks 37.8, 7.2 of it the encoder-decoder
# and VLM rank models, which take their forward and gradients from
# ``encdec``, written first).  The order is the shortest first, with
# ``ranks`` (about 33 s) last: the test files that wait for the others
# hold a pytest-xdist worker each, while tests/test_torch_group.py waits
# for its own gloo spawn too (the suite without test_kernels_multidev ran
# 265-297 s so, against 283-305 s with ``ranks`` before ``dryrun`` and
# ``moe_grad``, on one 8-core host).  ``recurrent`` and
# ``recurrent_grad`` precede ``ranks``: its hybrid and SSM rank models
# take their forward and gradients from them, and their odd prefills and
# engines then compile warm (2.8 s where they took 14.2 s alone).
LATER = ("counts", "collectives", "examples", "recurrent", "encdec",
         "recurrent_grad", "moe_grad", "dryrun", "ranks")
# The per-rank models of tests/test_torch_group.py beside TinyLlama, each
# reduced and in fp32: DeepSeek-V2-Lite with 8 experts (2 a rank of 4)
# and one shared expert; a SmolLM-360M with its 15 query and 5 K/V
# heads, which 4 ranks do not divide (the group drops their sharding);
# and an Arctic whose every cut 4 ranks do not divide (the vocabulary,
# the heads and ``wo``'s 66 rows, the 6 experts, the dense residual's 90
# hidden columns), so that a rank holds each leaf whole; at seq x batch
# of SyntheticLM(seed).
RANK_MODELS = {
    "deepseek": dict(arch="deepseek-v2-lite-16b", moe=dict(num_experts=8)),
    "seamless": dict(arch="seamless-m4t-large-v2"),
    "internvl": dict(arch="internvl2-76b"),
    "jamba": dict(arch="jamba-1.5-large-398b"),
    "xlstm": dict(arch="xlstm-1.3b"),
    "smollm": dict(arch="smollm-360m", d_model=240, num_heads=15,
                   num_kv_heads=5, head_dim=16),
    "indivisible": dict(arch="arctic-480b", vocab_size=510, num_heads=3,
                        num_kv_heads=3, head_dim=22,
                        moe=dict(num_experts=6, d_ff_expert=90,
                                 dense_residual_ff=90)),
}
RANK_TRAIN = dict(seq=32, batch=2, seed=0)
# An odd prompt for the dense model per rank: 4 ranks do not divide its
# length, so a rank keeps the residual stream replicated.
RANK_ODD = dict(seq=30, batch=2, seed=1)
# The engines per rank: batch requests of each prompt length (one the group
# of 4 divides, one it does not), new tokens each, at a cache whose time
# axis the reference's rule cuts over 4 ranks.
RANK_ENGINE = dict(batch=2, prompts=(5, 8), new=4, cache=1024, seed=53)
# The rank models whose prefill also runs at RANK_ODD's shape: the
# encoder-decoder's 30 frames, the VLM's 8 + 22 joined positions and the
# hybrid's and SSM's 30 tokens, which a group of 4 does not divide (the
# residual replicated).
RANK_ODD_PREFILL = ("seamless", "internvl", "jamba", "xlstm")
# The rank models whose one-device forward, loss and gradients at
# RANK_TRAIN's shape earlier entries hold already (the same reduced
# config, params and batch): the entry of the logits and the one of the
# loss and gradients.  ``ranks`` computes only their odd prefill and
# engines, and the tests take the rest from those entries.
RANK_SHARED = {"seamless": ("encdec", "encdec"),
               "internvl": ("encdec", "encdec"),
               "jamba": ("recurrent", "recurrent_grad"),
               "xlstm": ("recurrent", "recurrent_grad")}
# An encoder-decoder engine's encoder lengths: one the reference's rule
# keeps whole on every rank and one whose time axis it cuts over 4 ranks.
RANK_ENC = (16, 1024)
# The MLA layer with heads that a group of 4 does not divide (the reduced
# DeepSeek-V2-Lite's latent and head widths with 6 heads): every
# projection's columns divide, so a rank's block straddles heads; batch,
# prompt length and decode steps.
RANK_MLA = dict(heads=6, batch=2, seq=32, decode=5, seed=57)
# The recurrent layers per rank at the narrowest widths at which the
# reference's cache rule cuts their state over 4 ranks (1024 or more): a
# Mamba layer of d_inner 1024 (the reduced Jamba's d_model 256, expand
# 4), an mLSTM of 4 heads of 1024 (the reduced xLSTM's d_model 256 and 4
# heads, proj_factor 16) and an sLSTM of d_inner 1024 (proj_factor 4);
# batch, prompt length (4 divides it) and decode steps.
RANK_RECURRENT = dict(kinds=("mamba", "mlstm", "slstm"), batch=2, seq=8,
                      decode=4, seed=58)


def engine_frames(d_model: int, enc_len: int) -> np.ndarray:
    """The frames (float32) an encoder-decoder engine's ``RANK_ENGINE``
    requests are encoded from: ``enc_len`` of width ``d_model`` each."""
    rng = np.random.default_rng(RANK_ENGINE["seed"] + enc_len)
    return rng.standard_normal((RANK_ENGINE["batch"], enc_len, d_model)
                               ).astype(np.float32)


def mla_operands(d_model: int, cfg) -> tuple:
    """The MLA layer case's params (the reference's ``mla_init`` tree of
    ``RANK_MLA["heads"]`` heads at ``cfg``'s widths, either package's
    ``MLAConfig``, each leaf normal over the square root of its input
    width), its input x (B, S, d_model) and the cotangent of its output;
    float32 numpy."""
    rng = np.random.default_rng(RANK_MLA["seed"])
    h, r = RANK_MLA["heads"], cfg.kv_lora_rank
    shapes = {"wq": (d_model, h * (cfg.nope_head_dim + cfg.rope_head_dim)),
              "w_dkv": (d_model, r), "w_kr": (d_model, cfg.rope_head_dim),
              "w_uk": (r, h * cfg.nope_head_dim),
              "w_uv": (r, h * cfg.v_head_dim),
              "wo": (h * cfg.v_head_dim, d_model)}
    params = {k: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
        np.float32) for k, shape in shapes.items()}
    shape = (RANK_MLA["batch"], RANK_MLA["seq"], d_model)
    return (params, *(rng.standard_normal(shape).astype(np.float32)
                      for _ in range(2)))


def recurrent_layer_config(get_config, kind: str) -> tuple:
    """A ``RANK_RECURRENT`` layer's (d_model, heads, mixer config) from
    either package's ``get_config``: the reduced Jamba's Mamba config at
    expand 4, or the reduced xLSTM's at proj_factor 16 (mLSTM) or 4
    (sLSTM)."""
    if kind == "mamba":
        cfg = get_config("jamba-1.5-large-398b").reduced()
        return cfg.d_model, 0, dataclasses.replace(cfg.hybrid.mamba,
                                                   expand=4)
    cfg = get_config("xlstm-1.3b").reduced()
    return cfg.d_model, cfg.num_heads, dataclasses.replace(
        cfg.xlstm, proj_factor=16.0 if kind == "mlstm" else 4.0)


def recurrent_operands(kind: str, d_model: int, heads: int, cfg) -> tuple:
    """A ``RANK_RECURRENT`` layer's params (the reference's init tree of
    ``kind`` at ``cfg``'s widths; a weight normal over the square root of
    its input width, a vector near its init), its input x (B, S,
    d_model) and the cotangent of its output; float32 numpy."""
    rng = np.random.default_rng(RANK_RECURRENT["seed"])

    def draw(*shape, scale=None):
        w = rng.standard_normal(shape, dtype=np.float32)
        return w / np.float32(np.sqrt(shape[0])) if scale is None \
            else w * np.float32(scale)

    def near(value, n):
        return np.float32(value) + draw(n, scale=0.1)

    if kind == "mamba":
        d = cfg.expand * d_model
        r, n = cfg.dt_rank or -(-d_model // 16), cfg.d_state
        params = {"w_in": draw(d_model, 2 * d),
                  "conv_w": draw(cfg.d_conv, d, scale=0.1),
                  "conv_b": near(0.0, d), "w_x": draw(d, r + 2 * n),
                  "w_dt": draw(r, d), "dt_bias": near(0.0, d),
                  "a_log": np.log(np.broadcast_to(
                      np.arange(1, n + 1, dtype=np.float32), (d, n)).copy()),
                  "d_skip": near(1.0, d), "w_out": draw(d, d_model)}
    elif kind == "mlstm":
        d = int(cfg.proj_factor * d_model)
        params = {"w_up": draw(d_model, 2 * d), "wq": draw(d, d),
                  "wk": draw(d, d), "wv": draw(d, d),
                  "w_if": draw(d, 2 * heads), "w_out": draw(d, d_model),
                  "skip_scale": near(1.0, d)}
    else:
        d = int(cfg.proj_factor * d_model)
        params = {"w_up": draw(d_model, d), "w_gates": draw(d, 4 * d),
                  "r_gates": draw(d, 4 * d, scale=0.02),
                  "w_out": draw(d, d_model)}
    shape = (RANK_RECURRENT["batch"], RANK_RECURRENT["seq"], d_model)
    return params, draw(*shape, scale=1.0), draw(*shape, scale=1.0)


def engine_prompts(vocab: int, length: int) -> list:
    """``RANK_ENGINE``'s prompts of ``length`` tokens (int32 arrays)."""
    rng = np.random.default_rng(RANK_ENGINE["seed"])
    return list(rng.integers(0, vocab, (RANK_ENGINE["batch"], length))
                .astype(np.int32))


def rank_config(get_config, name: str):
    """``RANK_MODELS[name]``'s config from either package's
    ``get_config``."""
    spec = dict(RANK_MODELS[name])
    cfg = get_config(spec.pop("arch")).reduced()
    if "moe" in spec:
        spec["moe"] = dataclasses.replace(cfg.moe, **spec["moe"])
    return dataclasses.replace(cfg, **spec)


def spec_paths(flat) -> dict:
    """``{path: spec entries}`` from ``(path, spec)`` pairs, each path a
    sequence of dict keys and list positions, joined by "/"."""
    return {"/".join(str(k) for k in path): tuple(spec)
            for path, spec in flat}


def schedule_operands():
    """x (g, m_s, K) and w (g, K, n_local) fp32, rank r's block at [r]:
    the reference's shard_map blocks of (g * m_s, K) and (K, g *
    n_local)."""
    g, m_s, k, n = (COLLECTIVES[key] for key in ("g", "m_s", "k", "n_local"))
    rng = np.random.default_rng(COLLECTIVES["seed"])
    return (rng.standard_normal((g, m_s, k)).astype(np.float32),
            rng.standard_normal((g, k, n)).astype(np.float32))


def reduce_operands():
    """y (g, *COLLECTIVES["reduce"]) fp32, rank r's block at [r], for the
    reductions (``lax.psum``, ``lax.pmax``)."""
    rng = np.random.default_rng(COLLECTIVES["seed"] + 1)
    return rng.standard_normal(
        (COLLECTIVES["g"], *COLLECTIVES["reduce"])).astype(np.float32)


# The reduced TinyLlama's train steps (fp32) that the port's training is
# held to, in the pytest process: the substrate tests' shape.
TRAIN = dict(arch="tinyllama-1.1b", seq=32, batch=4, steps=2,
             ocfg=dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10))


def train_reference() -> dict:
    """The reference's state from ``PRNGKey(0)`` and its jitted train step
    run for ``TRAIN["steps"]`` steps on ``SyntheticLM``'s batches, run
    in the calling process (it imports JAX): each step's metrics and
    state (numpy), the batches, the loss and ce at the first batch, and
    the config, model and shape."""
    import jax

    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.data.pipeline import SyntheticLM
    from repro.models.model import build_model
    from repro.train import optimizer
    from repro.train.loop import init_train_state, make_train_step

    cfg = get_config(TRAIN["arch"]).reduced()
    shape = ShapeConfig("t", seq_len=TRAIN["seq"],
                        global_batch=TRAIN["batch"], kind="train")
    model = build_model(cfg)
    state = init_train_state(model, jax.random.PRNGKey(0))
    step = jax.jit(make_train_step(
        model, optimizer.OptimizerConfig(**TRAIN["ocfg"])))
    data = SyntheticLM(cfg, shape)
    batches = [data.batch_at(i) for i in range(TRAIN["steps"])]
    states, metrics = [], []
    s = state
    for b in batches:
        s, m = step(s, b)
        states.append(jax.tree.map(np.asarray, s))
        metrics.append({k: float(v) for k, v in m.items()})
    loss, parts = jax.jit(model.loss)(state["params"], batches[0])
    return dict(
        cfg=cfg, model=model, shape=shape, batches=batches,
        state=jax.tree.map(np.asarray, state), states=states,
        metrics=metrics, loss=float(loss), ce=float(parts["ce"]),
    )


def recurrent_requests(request_cls, vocab: int) -> list:
    """``RECURRENT["batch"]`` requests of ``request_cls`` (either
    package's ``Request``) with seeded prompts of unequal lengths."""
    rng = np.random.default_rng(RECURRENT["seed"])
    return [request_cls(rng.integers(0, vocab, RECURRENT["prompt"] - i)
                        .astype(np.int32), RECURRENT["new"])
            for i in range(RECURRENT["batch"])]


class FakeClock:
    """An injected monotonic clock the script advances by hand."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def adapt_script(pkg: str, cache_path: str, **tier_kw) -> dict:
    """Drive ``pkg``'s ``AdaptiveTier`` (``"repro"`` or ``"repro_torch"``)
    on ``TPU_V5E`` through the scripted run above; returns every pick,
    the re-fit's report, the deployed gate's JSON, the machine the fit
    deployed, ``stats()`` and the sentinel's events without timestamps.
    """
    import importlib

    adapt = importlib.import_module(f"{pkg}.serve.adapt")
    AutotuneCache = importlib.import_module(
        f"{pkg}.autotune.cache").AutotuneCache
    Autotuner = importlib.import_module(f"{pkg}.autotune.tuner").Autotuner
    TPU_V5E = importlib.import_module(f"{pkg}.core.machine").TPU_V5E
    GemmShape = importlib.import_module(f"{pkg}.core.workload").GemmShape
    stream = importlib.import_module(f"{pkg}.sweep.synth")

    clock = FakeClock()
    tuner = Autotuner(cache=AutotuneCache(path=cache_path), backend="numpy",
                      persist="defer")
    tier = adapt.AdaptiveTier(
        tuner, machine=TPU_V5E, clock=clock,
        config=adapt.AdaptConfig(explore_rate=0.0,
                                 explore_burst=ADAPT["burst"]),
        measure_fn=adapt.simulated_measure_fn(TPU_V5E, seed=0), **tier_kw,
    )
    tier.policy.set_sigma(ADAPT["sigma"])
    uniform = [GemmShape(*g) for g in ADAPT_UNIFORM]
    picks, report = [], None
    for i, req in enumerate(stream.drifting_request_stream(
            ADAPT["n"], seed=ADAPT["seed"],
            drift_every=ADAPT["drift_every"])):
        if i == ADAPT["refit_at"]:
            report = tier.refit_now()
        if i % ADAPT["uniform_every"] == 0:
            j = i // ADAPT["uniform_every"]
            dec = tier.pick(uniform[j % len(uniform)])
        else:
            dec = tier.pick(req.gemm, profile=req.profile)
        picks.append((dec.key, dec.source, dec.schedule.value,
                      dec.model_total_s, dec.measured_total_s))
        clock.advance(ADAPT["dt"])
    events = [{k: v for k, v in ev.items() if k != "ts"}
              for ev in tier.sentinel.events]
    return {
        "picks": picks,
        "report": report,
        "gate": tier.tuner.gate.to_json(),
        "link_bw": (TPU_V5E.link_bw, tier.machine.link_bw),
        "machine_name": tier.machine.name,
        "stats": tier.stats(),
        "events": events,
    }


def decode_attn_operands():
    """q (B, 1, H, D), k_new and v_new (B, 1, KV, D), the caches (B, S,
    KV, D), fp32."""
    b, s, h, kv, d = (DECODE_ATTN[k] for k in ("b", "s", "h", "kv", "d"))
    rng = np.random.default_rng(DECODE_ATTN["seed"])

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (draw(b, 1, h, d), draw(b, 1, kv, d), draw(b, 1, kv, d),
            draw(b, s, kv, d), draw(b, s, kv, d))


def moe_operands():
    """x (g, E, C, D), w_up (g, E/g, D, F), w_down (g, E/g, F, D) in
    fp32, rank r's block at [r]: the reference's shard_map blocks of
    (g * E, C, D), (E, D, F) and (E, F, D)."""
    g, e, c, d, f = (MOE[k] for k in "gecdf")
    rng = np.random.default_rng(MOE["seed"])
    x = rng.standard_normal((g, e, c, d)).astype(np.float32)
    w_up = (rng.standard_normal((g, e // g, d, f)) / np.sqrt(d)).astype(
        np.float32)
    w_down = (rng.standard_normal((g, e // g, f, d)) / np.sqrt(f)).astype(
        np.float32)
    return x, w_up, w_down


def _write(path: str, obj) -> None:
    """Pickle ``obj`` to ``path`` atomically."""
    tmp = path + ".partial"
    with open(tmp, "wb") as fh:
        pickle.dump(obj, fh)
    os.replace(tmp, path)


def main(err_path: str, first_path: str, *later_paths: str) -> None:
    """Write the first entries to ``first_path`` and each of ``LATER`` to
    its own of ``later_paths`` (each atomically), or the traceback to
    ``err_path``."""
    later = {
        "counts": _counts,
        "collectives": _collectives,
        "examples": _examples,
        "encdec": lambda: {a: _encdec(a) for a in ENCDEC["archs"]},
        "ranks": lambda: {n: _rank_model(n)
                          for n in ("dense", *RANK_MODELS)},
        "recurrent_grad": lambda: {a: _grad(a, RECURRENT_TRAIN)
                                   for a in RECURRENT_TRAIN["archs"]},
        "recurrent": lambda: {a: _recurrent(a) for a in RECURRENT["archs"]},
        "dryrun": _dryrun,
        "moe_grad": lambda: {a: _grad(a) for a in MOE_TRAIN["archs"]},
    }
    paths = dict(zip(LATER, later_paths, strict=True))
    try:
        _write(paths["collectives"], later.pop("collectives")())
        _write(first_path, _evaluate())
        for name in LATER:
            if name in later:
                _write(paths[name], later[name]())
    except BaseException:
        with open(err_path, "w") as fh:
            fh.write(traceback.format_exc())
        raise


def _evaluate() -> dict:
    import jax
    import jax.experimental
    import jax.numpy as jnp

    jax.experimental.enable_x64 = jax.enable_x64
    from repro.autotune import jaxgrid
    from repro.core import TABLE_I, synthetic_scenarios
    from repro.core.machine import MI300X
    from repro.core.schedule_types import Schedule
    from repro.core.workload import GemmShape, machine_grid
    from repro.learn import fit_machine, synthesize_records
    from repro.sweep import synthetic_batch, synthetic_ragged_batch

    machines = machine_grid()[:N_GRID_MACHINES]
    out = {}
    with jax.enable_x64():
        mp = jaxgrid.machine_arrays(machines)
        sb = synthetic_batch(DENSE["n"], seed=DENSE["seed"])

        def total_sum(lb, sh):
            raw = jaxgrid.evaluate_grid_raw(
                sb, mp._replace(link_bw=lb, s_half=sh)
            )
            return jnp.sum(jnp.where(raw[5], raw[0], 0.0)), raw

        (_, raw), grads = jax.value_and_grad(
            total_sum, argnums=(0, 1), has_aux=True
        )(mp.link_bw, mp.s_half)
        out["dense"] = [jax.device_get(a) for a in raw]
        out["dense_grad"] = [jax.device_get(g) for g in grads]
    out["ragged"] = [
        jax.device_get(a) for a in jaxgrid.evaluate_ragged_grid_raw(
            synthetic_ragged_batch(**RAGGED),
            machine_grid(groups=RAGGED_GROUPS),
        )
    ]
    gemms = [s.gemm for s in TABLE_I]
    out["tau"] = (jaxgrid.calibrate_tau(MI300X, gemms),
                  jaxgrid.calibrate_tau_reference(MI300X, gemms))
    out["shortlist"] = [
        [(s.value, t) for s, t in jaxgrid.shortlist(
            GemmShape(*g), MI300X, top=6, backend="jax")]
        for g in SHORTLIST_GEMMS
    ]
    true = {"link_bw": MI300X.link_bw * FIT_TRUE["link_bw_scale"],
            "s_half": FIT_TRUE["s_half"]}
    records = synthesize_records(
        MI300X, [s.gemm for s in synthetic_scenarios(12)],
        (Schedule.SERIAL, Schedule.UNIFORM_FUSED_1D,
         Schedule.HETERO_UNFUSED_1D),
        overrides=true,
    )
    fit = fit_machine(MI300X, records, params=("link_bw", "s_half"),
                      steps=FIT_STEPS)
    out["fit_records"] = [
        ((r.gemm.m, r.gemm.n, r.gemm.k, r.gemm.dtype_bytes),
         r.schedule.value, r.seconds) for r in records
    ]
    out["fit"] = fit.to_payload()
    out["moe"] = _moe_dispatch()
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out["adapt"] = adapt_script(
            "repro", os.path.join(tmp, "adapt.json"))
    out["decode_attn"] = _decode_attn()
    return out


def _numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _grad(arch: str, spec: dict = MOE_TRAIN) -> dict:
    """The reduced ``arch`` in fp32: params, ``spec["steps"]`` batches of
    ``SyntheticLM``, the loss and gradients at batch 0, and the train
    steps' metrics and last state."""
    import jax

    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.data.pipeline import SyntheticLM
    from repro.models.model import build_model
    from repro.train import optimizer
    from repro.train.loop import init_train_state, make_train_step

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    data = SyntheticLM(cfg, ShapeConfig("t", spec["seq"], spec["batch"],
                                        "train"), seed=spec["seed"])
    batches = [data.batch_at(i) for i in range(spec["steps"])]
    state = init_train_state(model, jax.random.PRNGKey(0))
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(state["params"], batches[0])
    step = jax.jit(make_train_step(model,
                                   optimizer.OptimizerConfig(**OCFG)))
    metrics, s = [], state
    for b in batches:
        s, m = step(s, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": _numpy(state["params"]), "batches": batches,
            "loss": float(loss), "ce": float(parts["ce"]),
            "aux": float(parts["aux"]),
            "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
            "state": _numpy(s), "metrics": metrics}


def _rank_model(name: str) -> dict:
    """``RANK_MODELS[name]`` (or, ``"dense"``, the reduced TinyLlama at
    ``RANK_ODD``'s shape): the forward's logits on batch 0 (without its
    labels), and the loss, gradients and their global norm (what a train
    step reports, ``optimizer.global_norm``) at batch 0, in one jitted
    function (but for ``RANK_SHARED``); the logits at ``RANK_ODD``'s shape for each of
    ``RANK_ODD_PREFILL``; and the ``DecodeEngine``'s tokens for each of
    ``RANK_ENGINE``'s prompt lengths and each encoder length
    (``RANK_ENC``, 0 without an encoder), keyed (length, enc_len)."""
    import jax

    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.data.pipeline import SyntheticLM
    from repro.models.model import build_model
    from repro.serve.engine import DecodeEngine, Request
    from repro.train.optimizer import global_norm

    if name == "dense":
        cfg, shape = get_config("tinyllama-1.1b").reduced(), RANK_ODD
    else:
        cfg, shape = rank_config(get_config, name), RANK_TRAIN
    model = build_model(cfg)

    def batch_at(shape):
        return SyntheticLM(cfg, ShapeConfig("t", shape["seq"],
                                            shape["batch"], "train"),
                           seed=shape["seed"]).batch_at(0)

    def inputs(batch):
        return {k: v for k, v in batch.items() if k != "labels"}

    batch = batch_at(shape)

    def run(params, batch):
        logits, _ = model.forward(params, inputs(batch))
        (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
            params, batch)
        return logits, loss, grads, global_norm(grads)

    params = model.init(jax.random.PRNGKey(0))
    out = {"engine": {}}
    # The reference's engine carries the recurrent state one run leaves
    # into the next (ROADMAP R7): each run starts from a fresh cache here.
    recurrent = cfg.hybrid is not None or cfg.xlstm is not None
    if name not in RANK_SHARED:
        logits, loss, grads, norm = jax.jit(run)(params, batch)
        out.update(logits=np.asarray(logits, np.float32), loss=float(loss),
                   grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
                   grad_norm=float(norm))
    if name in RANK_ODD_PREFILL:
        odd, _ = jax.jit(model.forward)(params, inputs(batch_at(RANK_ODD)))
        out["logits_odd"] = np.asarray(odd, np.float32)
    for enc_len in (RANK_ENC if cfg.encdec else (0,)):
        engine = DecodeEngine(cfg, params, batch_size=RANK_ENGINE["batch"],
                              cache_len=RANK_ENGINE["cache"], enc_len=enc_len)
        if enc_len:
            engine.cache = jax.jit(model.prefill_cross)(
                params, engine.cache, engine_frames(cfg.d_model, enc_len))
        for length in RANK_ENGINE["prompts"]:
            if recurrent:
                engine.cache = model.init_cache(RANK_ENGINE["batch"],
                                                RANK_ENGINE["cache"])
            out["engine"][length, enc_len] = [
                [int(t) for t in r.out] for r in engine.run(
                    [Request(p, RANK_ENGINE["new"])
                     for p in engine_prompts(cfg.vocab_size, length)])]
    return out


def _encdec(arch: str) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.data.pipeline import SyntheticLM
    from repro.models.model import build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = SyntheticLM(cfg, ShapeConfig("t", ENCDEC["seq"], ENCDEC["batch"],
                                         "train"),
                        seed=ENCDEC["seed"]).batch_at(0)
    # The forward and the gradients in one compiled function.
    (logits, aux), ((loss, parts), grads) = jax.jit(lambda p, b: (
        model.forward(p, b),
        jax.value_and_grad(model.loss, has_aux=True)(p, b)))(params, batch)
    enc_len = batch["enc_frames"].shape[1] if cfg.encdec else 0
    cache = model.init_cache(ENCDEC["batch"], ENCDEC["cache"],
                             enc_len=enc_len)
    if cfg.encdec:
        cache = jax.jit(model.prefill_cross)(params, cache,
                                             batch["enc_frames"])
    step = jax.jit(model.decode_step)
    decode = []
    for pos in range(ENCDEC["decode"]):
        lg, cache = step(params, cache, batch["tokens"][:, pos:pos + 1],
                         jnp.int32(pos))
        decode.append(np.asarray(lg))
    return {"params": _numpy(params), "batch": batch,
            "logits": np.asarray(logits), "aux": float(aux),
            "loss": float(loss), "ce": float(parts["ce"]),
            "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
            "decode": np.concatenate(decode, axis=1)}


def _recurrent(arch: str, dtype: str | None = None) -> dict:
    """The reduced ``arch`` (in ``dtype``, else its own): its params,
    batch, forward, loss and cached decode, and, in its own dtype, the
    tokens of two ``DecodeEngine.run``s on one engine; in bf16 also
    under ``"bf16"`` for each of ``RECURRENT["bf16"]``, its params as
    fp32 (every bf16 value is one)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.data.pipeline import SyntheticLM
    from repro.models.model import build_model
    from repro.serve.engine import DecodeEngine, Request

    r = RECURRENT
    cfg = get_config(arch).reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = SyntheticLM(cfg, ShapeConfig("t", r["seq"], r["batch"], "train"),
                        seed=r["seed"]).batch_at(0)
    # The forward and the loss in one compiled function.
    (logits, aux), (loss, parts) = jax.jit(lambda p, b: (
        model.forward(p, b), model.loss(p, b)))(params, batch)
    cache = model.init_cache(r["batch"], r["cache"])
    step = jax.jit(model.decode_step)
    decode = []
    for pos in range(r["decode"]):
        lg, cache = step(params, cache, batch["tokens"][:, pos:pos + 1],
                         jnp.int32(pos))
        decode.append(np.asarray(lg, np.float32))
    out = {"params": jax.tree.map(lambda a: np.asarray(a, np.float32)
                                  if dtype else np.asarray(a), params),
           "batch": batch, "logits": np.asarray(logits, np.float32),
           "aux": float(aux), "loss": float(loss), "ce": float(parts["ce"]),
           "decode": np.concatenate(decode, axis=1)}
    if dtype:
        return out
    engine = DecodeEngine(cfg, params, batch_size=r["batch"],
                          cache_len=r["cache"])
    out["engine_runs"] = [[req.out for req in engine.run(
        recurrent_requests(Request, cfg.vocab_size))] for _ in range(2)]
    if arch in r["bf16"]:
        out["bf16"] = _recurrent(arch, "bfloat16")
    return out


def _counts() -> dict:
    from repro.configs import ARCHS, get_config
    from repro.roofline.analysis import count_params

    return {a: count_params(get_config(a)) for a in sorted(ARCHS)}


def _examples() -> dict:
    import contextlib
    import io
    import runpy

    import jax

    with contextlib.redirect_stdout(io.StringIO()):
        ns = runpy.run_path(str(ROOT / "examples" / "serve_batched.py"),
                            run_name="__main__")
    return {"serve_batched": {
        "params": jax.tree.map(np.asarray, ns["params"]),
        "tokens": [list(map(int, r.out)) for r in ns["out"]],
    }}


def _collectives() -> dict:
    import functools

    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.overlap.moe import serial_a2a_ffn
    from repro.overlap.schedules import SCHEDULE_FNS
    from repro.roofline.analysis import parse_collectives

    g = COLLECTIVES["g"]
    mesh = Mesh(np.array(jax.devices()[:g]), ("model",))

    def count(fn, in_specs, out_specs, *args):
        run = jax.jit(shard_map(
            functools.partial(fn, axis_name="model"), mesh=mesh,
            in_specs=in_specs, out_specs=out_specs, check_vma=False))
        stats = parse_collectives(run.lower(*args).compile().as_text())
        return stats.bytes_by_kind, stats.count_by_kind

    x, w = schedule_operands()
    x_full = x.reshape(-1, x.shape[-1])  # (g * m_s, K)
    w_full = np.concatenate(list(w), axis=1)  # (K, g * n_local)
    rows, cols = P("model", None), P(None, "model")
    out = {s.value: count(fn, (rows, cols), cols, x_full, w_full)
           for s, fn in SCHEDULE_FNS.items()}
    out["outputs"] = {}
    for dtype in ("float32", "bfloat16"):
        xd, wd = (jax.numpy.asarray(a, dtype) for a in (x_full, w_full))
        out["outputs"][dtype] = {
            s.value: np.asarray(jax.jit(shard_map(
                functools.partial(fn, axis_name="model"), mesh=mesh,
                in_specs=(rows, cols), out_specs=cols, check_vma=False,
            ))(xd, wd), np.float32)
            for s, fn in SCHEDULE_FNS.items()}
    y = reduce_operands()
    psum, pmax = jax.jit(shard_map(
        lambda a: (jax.lax.psum(a, "model"), jax.lax.pmax(a, "model")),
        mesh=mesh, in_specs=rows, out_specs=(P(None, None), P(None, None)),
        check_vma=False))(y.reshape(-1, y.shape[-1]))
    out["reduce"] = {"psum": np.asarray(psum), "pmax": np.asarray(pmax)}
    spec = P("model", None, None)
    out["serial_a2a"] = count(
        serial_a2a_ffn, (spec, spec, spec), spec,
        *[a.reshape(-1, *a.shape[2:]) for a in moe_operands()])
    return out


def _dryrun() -> dict:
    import types

    import jax
    from jax.sharding import PartitionSpec as P

    jax.devices()  # the backend is up before repro.launch.dryrun sets
    # XLA_FLAGS for 512 devices at import
    from repro.compat import set_mesh
    from repro.configs import ARCHS, SHAPES, get_config
    from repro.configs.base import ShapeConfig
    from repro.launch import dryrun
    from repro.launch import specs as specmod
    from repro.models.model import build_model
    from repro.parallel.context import overlap_context
    from repro.parallel.sharding import cache_specs, fix_param_specs
    from repro.roofline.analysis import parse_collectives

    def paths(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))
        return spec_paths(
            ([getattr(k, "key", getattr(k, "idx", None)) for k in path], sp)
            for path, sp in flat)

    meshes = [types.SimpleNamespace(shape=m) for m in DRYRUN["meshes"]]
    out = {"param_specs": {}, "fixed": {}, "cache": {}, "compiled": {}}
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        model = build_model(cfg)
        specs = model.param_specs()
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
        out["param_specs"][arch] = paths(specs)
        for i, mesh in enumerate(meshes):
            out["fixed"][arch, i] = paths(fix_param_specs(specs, shapes,
                                                          mesh))
        for name in DRYRUN["caches"]:
            shape = SHAPES[name]
            pcfg = dryrun.prepared_config(arch, shape, "gspmd_serial")
            cache = specmod.decode_specs(pcfg, shape)["cache"]
            for i, mesh in enumerate(meshes):
                out["cache"][arch, name, i] = paths(cache_specs(cache, mesh))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    for arch in DRYRUN["compiled"]:
        cfg = get_config(arch).reduced()
        for kind in DRYRUN["kinds"]:
            shape = ShapeConfig("t", DRYRUN["seq"], DRYRUN["batch"], kind)
            jitted, args, _ = dryrun._build_jitted(cfg, shape, mesh)
            with set_mesh(mesh):
                with overlap_context(cfg.overlap):
                    lowered = jitted.lower(*args)
                compiled = lowered.compile()
            stats = parse_collectives(compiled.as_text())
            out["compiled"][arch, kind] = (
                compiled.memory_analysis().argument_size_in_bytes,
                stats.bytes_by_kind, stats.count_by_kind)
    return out


def _decode_attn() -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.compat import set_mesh
    from repro.parallel import decode_attn

    mesh = Mesh(np.array(jax.devices()[:DECODE_ATTN["g"]]), ("model",))
    args = [jnp.asarray(a) for a in decode_attn_operands()]
    out = {}
    with set_mesh(mesh):
        run = jax.jit(decode_attn.shard_map_attn_decode)
        for pos in DECODE_ATTN_POS:
            out[pos] = [np.asarray(a) for a in run(*args, jnp.int32(pos))]
    return out


def _moe_dispatch() -> dict:
    import dataclasses
    import functools

    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.workload import StepProfile
    from repro.overlap.moe import ficco_a2a_ffn, serial_a2a_ffn
    from repro.tune.variants import default_variant

    g = MOE["g"]
    x, w_up, w_down = moe_operands()
    mesh = Mesh(np.array(jax.devices()[:g]), ("ep",))
    spec = P("ep", None, None)
    flat = [a.reshape(-1, *a.shape[2:]) for a in (x, w_up, w_down)]
    reverse = dataclasses.replace(
        default_variant("ficco_a2a_ffn", group=g), dispatch_order="reverse")
    cases = {
        "serial": (serial_a2a_ffn, {}),
        "default": (ficco_a2a_ffn, {}),
        "chunks3": (ficco_a2a_ffn, {"chunks": 3}),
        "reverse": (ficco_a2a_ffn, {"variant": reverse}),
        "skewed": (ficco_a2a_ffn,
                   {"profile": StepProfile.skewed(g, MOE_SKEW)}),
        "sizes": (ficco_a2a_ffn, {"chunk_sizes": MOE_SIZES}),
    }
    out = {}
    for name in MOE_CASES:
        fn, kw = cases[name]
        run = jax.jit(shard_map(
            functools.partial(fn, axis_name="ep", **kw), mesh=mesh,
            in_specs=(spec, spec, spec), out_specs=spec, check_vma=False,
        ))
        out[name] = np.asarray(run(*flat)).reshape(x.shape)
    return out


_LAUNCHED: list = []  # the subprocess this worker started, to be reaped


def _reap() -> None:
    """At the worker's exit, wait for the subprocess it started: another
    worker may still be waiting for a later pickle."""
    for proc in _LAUNCHED:
        proc.wait(timeout=600)


def _paths(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # shared by every worker of the session
    stem = root / "torch_jax_reference"
    pickles = {part: root / f"torch_jax_reference-{part}.pkl"
               for part in ("first", *LATER)}
    return (pickles, stem.with_suffix(".err"), stem.with_suffix(".lock"),
            stem.with_suffix(".started"))


def start(tmp_path_factory) -> None:
    """Launch the script in the background, unless a worker of this
    session already has."""
    pickles, err, lock, started = _paths(tmp_path_factory)
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        if started.exists():
            return
        started.touch()
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
            "PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={MOE['g']}")
        _LAUNCHED.append(subprocess.Popen(
            [sys.executable, __file__, str(err),
             *map(str, pickles.values())],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        ))
        atexit.register(_reap)


def reference(tmp_path_factory, timeout: float = 600.0, *,
              entry: str = "first"):
    """The script's first entries (a dict), or the value of ``entry``,
    one of ``LATER`` (see the module docstring); raises with the script's
    traceback if it failed."""
    start(tmp_path_factory)
    pickles, err, _, _ = _paths(tmp_path_factory)
    path = pickles[entry]
    deadline = time.monotonic() + timeout
    while not path.exists():
        if err.exists():
            raise RuntimeError(err.read_text()[-8000:])
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written within {timeout} s")
        time.sleep(0.1)
    with open(path, "rb") as fh:
        return pickle.load(fh)


if __name__ == "__main__":
    main(*sys.argv[1:])
