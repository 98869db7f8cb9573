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
                                                  all_to_all, ppermute)

    xr = torch.from_numpy(x[group.rank])
    return {
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


def engine(group, numpy_params, prompts, new_tokens: int, cache_lens):
    """A ``DecodeEngine`` on this rank of the reduced TinyLlama, with its
    MLP blocks and ``decode_attn="shard_map"``, at each cache length: the
    tokens of each request, and the K cache's positions on this rank."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OverlapConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.parallel.sharding import shard_mlp_params
    from repro_torch.serve.engine import DecodeEngine, Request

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              overlap=OverlapConfig(decode_attn="shard_map"))
    state = shard_mlp_params(params_from_jax(numpy_params, cfg, device="cpu"),
                             group.rank, group.size)
    out = {}
    for cache_len in cache_lens:
        eng = DecodeEngine(cfg, state, batch_size=len(prompts),
                           cache_len=cache_len, device="cpu")
        reqs = eng.run([Request(p, new_tokens) for p in prompts])
        out[cache_len] = ([list(r.out) for r in reqs],
                          eng.cache[0]["k"].shape[-3])
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


def prefill(group, numpy_params, tokens, mode: str, backend: str):
    """The reduced TinyLlama prefill on this rank: the params converted,
    this rank's MLP blocks kept, the logits (float32 numpy)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OverlapConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import shard_mlp_params
    from repro_torch.serve.engine import make_prefill

    cfg = dataclasses.replace(
        get_config("tinyllama-1.1b").reduced(),
        overlap=OverlapConfig(mode=mode, backend=backend))
    state = shard_mlp_params(params_from_jax(numpy_params, cfg, device="cpu"),
                             group.rank, group.size)
    logits = make_prefill(build_model(cfg))(
        state, {"tokens": torch.from_numpy(tokens).long()})
    return logits.float().numpy()


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
        "engine": engine(group, cases["params"], *cases["engine"]),
    }
    for mode, backend in cases["prefill_modes"]:
        out["prefill", mode, backend] = prefill(
            group, cases["params"], cases["tokens"], mode, backend)
    return out


def raise_on(group, bad_rank: int):
    """Rank ``bad_rank`` raises; the others wait at a barrier it never
    reaches."""
    if group.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    group.barrier()
    return group.rank
