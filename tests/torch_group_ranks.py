"""Rank bodies for ``tests/test_torch_group.py``, run by
``repro_torch.launch.group.spawn`` in processes of their own.

A spawned rank imports the module that holds its function again, so this
one imports neither JAX nor the reference: only torch and the port.  Every input arrives as numpy arrays; every result goes back as
numpy arrays and plain Python values.
"""

import dataclasses

import torch

# The port is imported inside the bodies: a rank of the launcher's own test
# (raise_on) then starts without it.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def schedules(group, x, w) -> dict:
    """Each schedule through ``ficco_linear`` on this rank's blocks of the
    (g, m_s, K) and (g, K, n_local) operands, in each dtype: its output
    (float32 numpy), and in float32 what ``counting()`` recorded."""
    from repro_torch.core.schedule_types import Schedule
    from repro_torch.overlap.api import ficco_linear
    from repro_torch.parallel.collectives import counting

    r = group.rank
    out = {}
    for name, dtype in DTYPES.items():
        xr = torch.from_numpy(x[r]).to(dtype)
        wr = torch.from_numpy(w[r]).to(dtype)
        for sched in Schedule:
            with counting() as stats:
                y = ficco_linear(xr, wr, schedule=sched)
            out[name, sched.value] = (
                y.float().numpy(), dict(stats.bytes_by_kind),
                dict(stats.count_by_kind))
    return out


def collectives(group, x) -> dict:
    """The per-rank collectives on this rank's block of x (g, m, ...)."""
    from repro_torch.parallel.collectives import (all_gather, all_reduce,
                                                  all_to_all, ppermute,
                                                  psum_scatter)

    xr = torch.from_numpy(x[group.rank])
    return {
        "psum_scatter": psum_scatter(xr, 0, group=group).numpy(),
        "all_gather": all_gather(xr, group=group).numpy(),
        "all_gather_tiled": all_gather(xr, tiled=True, group=group).numpy(),
        "all_to_all": all_to_all(xr[:group.size], group=group).numpy(),
        "ppermute": ppermute(xr, 1, group=group).numpy(),
        "ppermute_back": ppermute(xr, -1, group=group).numpy(),
        "all_reduce": all_reduce(xr, group=group).numpy(),
    }


def reductions(group, y) -> dict:
    """``all_reduce`` (``lax.psum``) and ``pmax`` (``lax.pmax``) of this
    rank's block of y (g, ...)."""
    from repro_torch.parallel.collectives import all_reduce, pmax

    yr = torch.from_numpy(y[group.rank])
    return {"psum": all_reduce(yr, group=group).numpy(),
            "pmax": pmax(yr, group=group).numpy()}


def decode_attention(group, operands, positions) -> dict:
    """The per-rank ``shard_map_attn_decode`` at each position, each from
    the operands as given (q, k_new, v_new, full caches): this rank's
    output and its time slice of the updated caches."""
    from repro_torch.parallel.decode_attn import shard_map_attn_decode

    q, k_new, v_new, k_full, v_full = map(torch.from_numpy, operands)
    s_loc = k_full.shape[1] // group.size
    rows = slice(group.rank * s_loc, (group.rank + 1) * s_loc)
    out = {}
    for pos in positions:
        k_c, v_c = k_full[:, rows].clone(), v_full[:, rows].clone()
        o, k2, v2 = shard_map_attn_decode(q, k_new, v_new, k_c, v_c, pos)
        out[pos] = (o.numpy(), k2.numpy(), v2.numpy(), k2 is k_c)
    return out


def engine(group, numpy_params, runs, cfg=None, states=None) -> dict:
    """A ``DecodeEngine`` on this rank of ``cfg`` (the reduced TinyLlama by
    default), with its blocks, for each of ``runs`` ((decode_attn, cache
    length, prompts, new tokens, encoder length, frames): an
    encoder-decoder's engine first encodes the (B, enc_len, d) frames):
    the tokens of each request, and the shape of every leaf of the
    engine's cache on this rank; keyed (decode_attn, cache length, prompt
    length, encoder length).  ``states``, a dict, takes each run's
    recurrent layers' decode state after it (numpy, by slot and leaf)."""
    from repro_torch.models.model import RECURRENT
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OverlapConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.serve.engine import DecodeEngine, Request

    cfg = cfg or get_config("tinyllama-1.1b").reduced()
    state = params_from_jax(numpy_params, cfg, device="cpu",
                            rank=group.rank, size=group.size)
    out = {}
    for decode_attn, cache_len, prompts, new, enc_len, frames in runs:
        eng = DecodeEngine(
            dataclasses.replace(cfg, overlap=OverlapConfig(
                decode_attn=decode_attn)),
            state, batch_size=len(prompts), cache_len=cache_len,
            enc_len=enc_len, device="cpu")
        if frames is not None:
            eng.encode(torch.from_numpy(frames))
        reqs = eng.run([Request(p, new) for p in prompts])
        key = decode_attn, cache_len, len(prompts[0]), enc_len
        out[key] = (
            [list(r.out) for r in reqs],
            [{k: tuple(v.shape) for k, v in c.items()} for c in eng.cache])
        if states is not None:
            states[key] = {(j, k): v.numpy() for j, (spec, c) in enumerate(
                zip(eng.model.pattern, eng.cache)) if spec.mixer in RECURRENT
                for k, v in c.items()}
    return out


def composers(group, x, w, variants) -> dict:
    """The K3 + K1 composer and K4 on this rank's shards, per variant,
    each called twice (the second through the same ring and shards)."""
    from repro_torch.kernels.dma_exchange import ficco_uniform_fused_1d_dma
    from repro_torch.kernels.ficco_ag_matmul import ficco_ag_matmul_fused
    from repro_torch.tune.variants import KernelVariant

    xr = torch.from_numpy(x[group.rank])
    wr = torch.from_numpy(w[group.rank])
    out = {}
    for spec in variants:
        key = tuple(sorted(spec.items()))
        for kernel, fn in (("dma_exchange", ficco_uniform_fused_1d_dma),
                           ("ficco_ag_matmul", ficco_ag_matmul_fused)):
            v = KernelVariant(kernel=kernel, **spec)
            out[kernel, key] = [
                fn(xr, wr, variant=v, peers=group.peers).numpy()
                for _ in range(2)]
    return out


def prefill(group, numpy_params, inputs, mode: str, backend: str,
            cfg=None):
    """The prefill of ``cfg`` (the reduced TinyLlama by default) on this
    rank, on ``inputs`` (the tokens, or a dict of them and a VLM's prefix
    or an encoder-decoder's frames): the params converted to this rank's
    blocks, the logits (float32 numpy) and the shape of the residual
    stream after each encoder layer and decoder period."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OverlapConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import make_prefill

    cfg = dataclasses.replace(
        cfg or get_config("tinyllama-1.1b").reduced(),
        overlap=OverlapConfig(mode=mode, backend=backend))
    state = params_from_jax(numpy_params, cfg, device="cpu",
                            rank=group.rank, size=group.size)
    if not isinstance(inputs, dict):
        inputs = {"tokens": inputs}
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    batch["tokens"] = batch["tokens"].long()
    with model_mod.residual_shapes() as shapes:
        logits = make_prefill(model_mod.build_model(cfg))(state, batch)
    return logits.float().numpy(), shapes


def ep_dispatch(group, x, w_up, w_down, cases: dict) -> dict:
    """The per-rank ``serial_a2a_ffn`` / ``ficco_a2a_ffn`` on this rank's
    blocks of the stacked (g, E, C, D), (g, E/g, D, F), (g, E/g, F, D)
    operands, for each case (name -> ficco_a2a_ffn's keyword arguments,
    None for the serial dispatch): its output and ``counting()``'s calls
    by kind."""
    from repro_torch.overlap.moe import ficco_a2a_ffn, serial_a2a_ffn
    from repro_torch.parallel.collectives import counting

    r = group.rank
    ops = [torch.from_numpy(a[r]) for a in (x, w_up, w_down)]
    out = {}
    for name, kw in cases.items():
        with counting() as stats:
            y = (serial_a2a_ffn(*ops, group=group) if kw is None
                 else ficco_a2a_ffn(*ops, group=group, **kw))
        out[name] = (y.numpy(), dict(stats.count_by_kind))
    return out


def collective_grads(group, x, cotangents: dict) -> dict:
    """The gradient of each per-rank collective of this rank's block of x
    (g, g, ...) for the cotangent of its output (stacked by rank, or one
    replicated array for ``all_reduce``)."""
    from repro_torch.parallel.collectives import (all_gather, all_reduce,
                                                  all_to_all, ppermute,
                                                  psum_scatter)

    r, g = group.rank, group.size
    fns = {
        "psum_scatter": lambda v: psum_scatter(v, 0, group=group),
        "all_gather_axis1": lambda v: all_gather(v, tiled=True, axis=1,
                                                 group=group),
        "all_gather": lambda v: all_gather(v, group=group),
        "all_gather_tiled": lambda v: all_gather(v, tiled=True, group=group),
        "all_to_all": lambda v: all_to_all(v, group=group),
        "ppermute": lambda v: ppermute(v, 1, group=group),
        "ppermute_back": lambda v: ppermute(v, -1, group=group),
        "all_reduce": lambda v: all_reduce(v, group=group),
    }
    out = {}
    for name, fn in fns.items():
        xr = torch.from_numpy(x[r]).requires_grad_(True)
        dy = cotangents[name]
        dy = torch.from_numpy(dy if name == "all_reduce" else dy[r])
        (grad,) = torch.autograd.grad(fn(xr), xr, dy)
        out[name] = grad.numpy()
    return out


def train_steps(group, numpy_params, mode: str, shape: tuple, ocfg: dict,
                steps: int, accum_steps: int = 1) -> dict:
    """``steps`` AdamW steps of ``make_train_step`` on this rank of the
    reduced TinyLlama (fp32) in ``mode`` on the collective backend, from
    the reference's params and fresh moments cut by
    ``shard_train_state`` (the model's ``rank_specs``), on
    ``SyntheticLM``'s batches at ``shape``
    (seq, batch): each step's metrics, K2 folds and ``counting()``'s
    calls by kind, and the last state's leaves with whether each is a
    rank's block."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OverlapConfig, ShapeConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.parallel.collectives import counting
    from repro_torch.parallel.sharding import rank_blocks, shard_train_state
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(
        get_config("tinyllama-1.1b").reduced(),
        overlap=OverlapConfig(mode=mode, backend="collective"))
    params = params_from_jax(numpy_params, cfg, device="cpu")
    model = build_model(cfg)
    specs = model.rank_specs(group.size)
    state = shard_train_state(
        {"params": params, "opt_state": opt.init_state(params)}, specs,
        group.rank, group.size)
    data = SyntheticLM(cfg, ShapeConfig("t", seq_len=shape[0],
                                        global_batch=shape[1], kind="train"))
    step = make_train_step(model, opt.OptimizerConfig(**ocfg),
                           accum_steps=accum_steps)
    folds, collectives = [], []
    real = ops.matmul_accumulate

    def spy(c, x, w):
        folds[-1] += 1
        return real(c, x, w)

    ops.matmul_accumulate = spy
    metrics = []
    try:
        for i in range(steps):
            folds.append(0)
            batch = {k: torch.from_numpy(v) for k, v in
                     data.batch_at(i).items()}
            with counting() as stats:
                state, m = step(state, batch)
            collectives.append(dict(stats.count_by_kind))
            metrics.append({k: v.item() for k, v in m.items()})
    finally:
        ops.matmul_accumulate = real
    return dict(metrics=metrics, folds=folds, collectives=collectives,
                leaves=[t.numpy() for t in leaves(state)],
                blocks=rank_blocks(state, {
                    "params": specs, "opt_state": opt.state_specs(specs)}))


def dma_refuses_grad(group, numpy_params, shape: tuple) -> str:
    """The error that ``loss_and_grads`` raises on this rank on the DMA
    backend (K3 + K1 have no reverse-mode rule)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OverlapConfig, ShapeConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import loss_and_grads

    cfg = dataclasses.replace(
        get_config("tinyllama-1.1b").reduced(),
        overlap=OverlapConfig(mode="uniform-fused-1d", backend="dma"))
    params = params_from_jax(numpy_params, cfg, device="cpu",
                             rank=group.rank, size=group.size)
    batch = SyntheticLM(cfg, ShapeConfig("t", seq_len=shape[0],
                                         global_batch=shape[1],
                                         kind="train")).batch_at(0)
    try:
        loss_and_grads(build_model(cfg), params,
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    except RuntimeError as err:
        return str(err)
    return "no error"


def rank_model(group, cfg, numpy_params, batch, backends, engine_runs,
               train_mode: str, odd_batch=None) -> dict:
    """One of the reference's per-rank models (``cfg``, fp32) on this
    rank, from the reference's params cut to the rank's blocks: the
    prefill's logits and residual shapes (:func:`prefill`) on ``batch``'s
    inputs in ``uniform-fused-1d`` on each of ``backends``, and on
    ``odd_batch``'s on the collective backend where given; its
    ``DecodeEngine``s (:func:`engine`, ``engine_runs``); and, in
    ``train_mode`` on the collective backend, ``loss_and_grads``' loss and
    gradient blocks at ``batch`` and one ``make_train_step`` step's
    metrics from fresh moments (none for ``train_mode`` None)."""
    from repro_torch.configs.base import OverlapConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import loss_and_grads, make_train_step
    from repro_torch.tree import leaves

    def inputs(b):
        return {k: v for k, v in b.items() if k != "labels"}

    out = {"prefill": {
        backend: prefill(group, numpy_params, inputs(batch),
                         "uniform-fused-1d", backend, cfg)
        for backend in backends}}
    if odd_batch is not None:
        out["prefill_odd"] = prefill(group, numpy_params, inputs(odd_batch),
                                     "uniform-fused-1d", "collective", cfg)
    out["states"] = {}
    out["engine"] = engine(group, numpy_params, engine_runs, cfg=cfg,
                           states=out["states"])
    if train_mode is None:
        return out
    tcfg = dataclasses.replace(cfg, overlap=OverlapConfig(
        mode=train_mode, backend="collective"))
    model = build_model(tcfg)
    params = params_from_jax(numpy_params, tcfg, device="cpu",
                             rank=group.rank, size=group.size)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = loss_and_grads(model, params, tbatch)
    out["loss"] = loss.item()
    out["grads"] = [g.numpy() for g in leaves(grads)]
    step = make_train_step(model, opt.OptimizerConfig())
    _, metrics = step({"params": params, "opt_state": opt.init_state(params)},
                      tbatch)
    out["metrics"] = {k: v.item() for k, v in metrics.items()}
    return out


def gather_grad(group, x, dy) -> dict:
    """``gather_replicated`` (dim 1) and ``all_gather`` (tiled, moved to
    dim 1) of this rank's block of x (g, m, n), each with the replicated
    cotangent ``dy`` (m, g * n): their outputs and gradients."""
    from repro_torch.parallel.collectives import all_gather, gather_replicated

    out = {}
    for name, fn in (
            ("gather_replicated",
             lambda v: gather_replicated(v, 1, group=group)),
            ("all_gather",
             lambda v: all_gather(v, group=group).movedim(0, 1).flatten(1))):
        xr = torch.from_numpy(x[group.rank]).requires_grad_(True)
        y = fn(xr)
        (grad,) = torch.autograd.grad(y, xr, torch.from_numpy(dy))
        out[name] = (y.detach().numpy(), grad.numpy())
    return out


def mla_layer(group, numpy_params, mla_cfg, heads: int, x, dy,
              decode: int, caches) -> dict:
    """An MLA layer whose ``heads`` the group does not divide, on this
    rank's blocks (``fix_param_specs`` of ``mla_param_specs`` on a
    model-only mesh: ``wq``, ``w_uk`` and ``w_uv`` by columns that
    straddle heads, ``wo`` by rows): ``mla_apply`` on the replicated x
    (B, S, d) and on the rank's sequence block of it, the gradient of
    sum(y * dy) with respect to the rank's leaves (from the sequence
    block), and ``mla_decode`` over x's first ``decode`` positions at
    each of ``caches`` lengths (the rule's block of the latent cache)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import mla
    from repro_torch.parallel.decode_attn import cache_positions
    from repro_torch.parallel.sharding import fix_param_specs, shard_params

    g, r = group.size, group.rank
    whole = {k: torch.from_numpy(v) for k, v in numpy_params.items()}
    specs = fix_param_specs(mla.mla_param_specs(), whole,
                            Mesh(("model",), (g,)))
    params = shard_params(whole, specs, r, g)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    b, s, _ = xt.shape
    positions = torch.arange(s).expand(b, s)
    n = s // g
    rows = slice(r * n, (r + 1) * n)
    out = {"blocks": {k: tuple(v.shape) for k, v in params.items()}}
    with torch.no_grad():
        out["replicated"] = mla.mla_apply(params, xt, heads, mla_cfg,
                                          positions=positions).numpy()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    y = mla.mla_apply(leaves, xt[:, rows], heads, mla_cfg,
                      positions=positions, seq=True)
    out["seq"] = y.detach().numpy()
    (y * dyt[:, rows]).sum().backward()
    out["grads"] = {k: v.grad.numpy() for k, v in leaves.items()}
    out["decode"] = {}
    with torch.no_grad():
        for cache_len in caches:
            here = cache_positions((1, b, cache_len, mla_cfg.kv_lora_rank))
            cache = mla.mla_init_cache(b, cache_len, mla_cfg, torch.float32,
                                       "cpu", positions=here)
            if here < cache_len:
                cache["time_slice"] = torch.tensor(r * here)
            ys = [mla.mla_decode(params, xt[:, t:t + 1], cache, t, heads,
                                 mla_cfg)[0] for t in range(decode)]
            out["decode"][cache_len] = (torch.cat(ys, 1).numpy(), here)
    return out


def recurrent_layer(group, kind: str, layer, decode: int) -> dict:
    """A Mamba, mLSTM or sLSTM layer (``kind``; ``layer`` its (d_model,
    heads, mixer config)) at widths where the reference's cache rule cuts
    its state, on this rank's blocks (``fix_param_specs`` of its
    ``param_specs`` on a model-only mesh), from
    ``torch_jax_reference.recurrent_operands`` (numpy, drawn here): its
    apply on the replicated x and on the rank's sequence block, the
    gradient of sum(y * dy) with respect to the rank's leaves (from the
    sequence block), and ``decode`` steps of its decode over x's first
    positions from the start state, the rank's block of each leaf by
    ``cache_block`` (the state at the end too)."""
    import torch_jax_reference  # numpy only: no JAX, no reference

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import mamba, xlstm
    from repro_torch.models.model import _state_start
    from repro_torch.parallel.decode_attn import cache_block
    from repro_torch.parallel.sharding import fix_param_specs, shard_params

    g, r = group.size, group.rank
    d_model, heads, cfg = layer
    numpy_params, x, dy = torch_jax_reference.recurrent_operands(
        kind, d_model, heads, cfg)
    whole = {k: torch.from_numpy(v) for k, v in numpy_params.items()}
    fns = {  # the specs, apply, the whole start state, decode
        "mamba": (mamba.mamba_param_specs,
                  lambda p, v, seq=False: mamba.mamba_apply(p, v, cfg,
                                                            seq=seq),
                  lambda b: mamba.mamba_init_cache(
                      b, d_model, cfg, torch.float32, "meta", lead=(1,)),
                  lambda p, v, c: mamba.mamba_decode(p, v, c, cfg)),
        "mlstm": (xlstm.mlstm_param_specs,
                  lambda p, v, seq=False: xlstm.mlstm_apply(
                      p, v, heads, cfg, seq=seq),
                  lambda b: xlstm.mlstm_init_cache(b, d_model, heads, cfg,
                                                   "meta", lead=(1,)),
                  lambda p, v, c: xlstm.mlstm_decode(p, v, c, heads, cfg)),
        "slstm": (xlstm.slstm_param_specs,
                  lambda p, v, seq=False: xlstm.slstm_apply(p, v, cfg,
                                                            seq=seq),
                  lambda b: xlstm.slstm_init_cache(b, d_model, cfg, "meta",
                                                   lead=(1,)),
                  lambda p, v, c: xlstm.slstm_decode(p, v, c, cfg)),
    }
    param_specs, apply, init_cache, step = fns[kind]
    specs = fix_param_specs(param_specs(), whole, Mesh(("model",), (g,)))
    params = shard_params(whole, specs, r, g)
    del whole, numpy_params
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    b, s, _ = xt.shape
    n = s // g
    rows = slice(r * n, (r + 1) * n)
    out = {"blocks": {k: tuple(v.shape) for k, v in params.items()}}
    with torch.no_grad():
        out["replicated"] = apply(params, xt).numpy()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    y = apply(leaves, xt[:, rows], seq=True)
    out["seq"] = y.detach().numpy()
    (y * dyt[:, rows]).sum().backward()
    out["grads"] = {k: v.grad.numpy() for k, v in leaves.items()}
    with torch.no_grad():
        cache = {k: torch.full(cache_block(v.shape), _state_start(k),
                               dtype=v.dtype)
                 for k, v in init_cache(b).items()}
        here = {k: v[0] for k, v in cache.items()}  # one period's views
        ys = [step(params, xt[:, t:t + 1], here)[0] for t in range(decode)]
    out["decode"] = torch.cat(ys, 1).numpy()
    out["cache"] = {k: v[0].numpy() for k, v in cache.items()}
    return out


def run_all(group, cases: dict) -> dict:
    """Every case of the module, in one spawn."""
    torch.manual_seed(0)
    out = {
        "schedules": schedules(group, *cases["schedules"]),
        "collectives": collectives(group, cases["collectives"]),
        "reductions": reductions(group, cases["reductions"]),
        "decode_attention": decode_attention(group,
                                             *cases["decode_attention"]),
        "composers": composers(group, *cases["composers"]),
    }
    for mode, backend in cases["prefill_modes"]:
        out["prefill", mode, backend] = prefill(
            group, cases["params"], cases["tokens"], mode, backend)
    out["ep"] = ep_dispatch(group, *cases["ep"])
    out["collective_grads"] = collective_grads(group,
                                               *cases["collective_grads"])
    for mode, accum in cases["train_modes"]:
        out["train", mode, accum] = train_steps(
            group, cases["params"], mode, *cases["train"],
            accum_steps=accum)
    out["dma_grad"] = dma_refuses_grad(group, cases["params"],
                                       cases["train"][0])
    out["gather_grad"] = gather_grad(group, *cases["gather_grad"])
    for name, args in cases["rank_models"].items():
        out["model", name] = rank_model(group, *args)
    out["mla"] = mla_layer(group, *cases["mla"])
    kinds, layers, decode = cases["recurrent"]
    for kind, layer in zip(kinds, layers):
        out["recurrent", kind] = recurrent_layer(group, kind, layer, decode)
    return out


def raise_on(group, bad_rank: int):
    """Rank ``bad_rank`` raises; the others wait at a barrier it never
    reaches."""
    if group.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    group.barrier()
    return group.rank
