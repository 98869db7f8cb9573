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
    (bytes by kind, count by kind);
  * ``dryrun``: the dry-run's specs, each tree as ``{path: tuple(spec)}``
    (:func:`spec_paths`): every arch's ``param_specs()``, and on each of
    ``DRYRUN["meshes"]`` (stand-ins with a ``shape``) its
    ``fix_param_specs`` and the ``cache_specs`` of each of
    ``DRYRUN["caches"]`` through ``prepared_config``; and for each of
    ``DRYRUN["compiled"]`` (reduced) and each step kind at ``DRYRUN``'s
    seq and batch on the forced devices as (data 2, model 2), the
    compiled step's ``argument_size_in_bytes`` and ``parse_collectives``
    (bytes by kind, count by kind).

The first eight entries go to ``FIRST.pkl``; the later ones (the whole
models, the slower half) follow, each in a pickle of its own, in
``LATER``'s order, so a test waits only for what it reads.

The script runs with ``MOE["g"]`` forced host devices
(``--xla_force_host_platform_device_count``); the other entries run on
the first, as they would on one.

:func:`start` launches the script once per test session, whatever the
number of pytest-xdist workers (the first caller, under a lock in the
session's shared temporary directory), in the background: the port's
own tests run meanwhile.  :func:`reference` waits for its pickle.
"""

import atexit
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
# output columns each (row chunks of m_s / g, K slices of K / g).
COLLECTIVES = dict(g=4, m_s=16, k=32, n_local=8, seed=41)
# The dry-run's spec stand-ins and compiled steps.
DRYRUN = dict(meshes=({"data": 16, "model": 16},
                      {"pod": 2, "data": 16, "model": 16},
                      {"data": 2, "model": 2}),
              caches=("decode_32k", "long_500k"),
              compiled=("tinyllama-1.1b", "xlstm-1.3b"),
              kinds=("prefill", "train"), seq=64, batch=8)
# The entries after the first eight, in the order the script writes them,
# each holding a pytest-xdist worker that waits for it (seconds alone, on
# one run: counts 5.8, collectives 1.2, recurrent_grad 18.3, encdec 9.7,
# recurrent 8.9, dryrun 15.8, moe_grad 17.1).
LATER = ("counts", "collectives", "recurrent_grad", "encdec", "recurrent",
         "dryrun", "moe_grad")


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
        "recurrent_grad": lambda: {a: _grad(a, RECURRENT_TRAIN)
                                   for a in RECURRENT_TRAIN["archs"]},
        "encdec": lambda: {a: _encdec(a) for a in ENCDEC["archs"]},
        "recurrent": lambda: {a: _recurrent(a) for a in RECURRENT["archs"]},
        "dryrun": _dryrun,
        "moe_grad": lambda: {a: _grad(a) for a in MOE_TRAIN["archs"]},
    }
    try:
        _write(first_path, _evaluate())
        for name, path in zip(LATER, later_paths, strict=True):
            _write(path, later[name]())
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
    logits, aux = jax.jit(model.forward)(params, batch)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, batch)
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
    logits, aux = jax.jit(model.forward)(params, batch)
    loss, parts = jax.jit(model.loss)(params, batch)
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
