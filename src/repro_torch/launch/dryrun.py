"""Dry-run: the sharded step of every (arch x shape) on a production mesh,
with no device and no allocation.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k [--multi-pod] [--overlap-mode ficco_auto] \\
      [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # 10 x 4 matrix

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
step on 256 or 512 placeholder devices and reads XLA's memory analysis and
the collectives its partitioner inserted.  The port has no partitioner.
For each pair it builds what the reference builds before compiling, the
same way: the parameter shapes (``Model.init`` on the ``"meta"`` device),
their specs fixed for the mesh (``Model.param_specs`` through
:func:`~repro_torch.parallel.sharding.fix_param_specs`), the optimizer
state's (``train/optimizer.state_specs``; bf16 moments above 1e11
parameters), the batch's and the decode cache's
(:func:`~repro_torch.parallel.sharding.cache_specs`); and it counts the
rest from them.

Held to the reference (``tests/test_torch_dryrun.py``):

  * the specs, leaf for leaf;
  * ``argument_bytes``: the per-device bytes of the step's arguments, each
    leaf's shard shape times its itemsize, which is what XLA's
    ``memory_analysis().argument_size_in_bytes`` reports;
  * ``hlo_flops`` and ``hlo_bytes`` from ``counters.step_costs``, which the
    reference writes over XLA's cost analysis, and ``model_flops``.

The port's own:

  * ``bytes_per_device`` is ``argument_bytes`` plus ``output_bytes``: the
    new state under the input specs for ``train``; the logits under
    ``(batch, None, model)`` for ``prefill``, and the logits and the new
    cache under the cache's specs for ``decode``.  XLA's temporaries are
    not counted, so it is a lower bound of the reference's figure.
  * The collectives are counted from the fixed specs, one rule per kind,
    as an FSDP plus tensor-parallel deployment in PyTorch issues them
    (GSPMD's choices differ; ``PERF.md`` compares the two).  A training
    step runs ``accum_steps`` microbatches, each a forward (two with
    ``remat``: the periods and encoder layers are recomputed, with no
    collective under ``remat_policy="dots"``, whose products are kept)
    and a backward:

      - FSDP: each weight sharded over ``data`` is all-gathered over
        ``data`` at every forward and backward use, once per layer;
        training reduce-scatters its gradient over ``data`` (then
        all-reduces the shard over ``pod``), and all-reduces over the
        batch axes the gradient of every weight they do not shard;
      - tensor parallel: each projection whose contracting dim is sharded
        over ``model`` (``wo``, ``w_down``, the mixers' output and
        ``w_x`` / ``w_gates`` projections) and the lookup in a
        vocabulary-sharded ``embed`` all-reduce their output over
        ``model``; in training each projection whose output dim is
        sharded over ``model`` (the column-parallel ones, and a
        vocabulary-sharded unembedding) all-reduces its input gradient,
        and the vocabulary-sharded loss all-reduces its max, its sum and
        its gold logit;
      - each MoE layer whose experts are sharded over ``model`` issues a
        dispatch and a combine all-to-all of its capacity buffer, and
        their transposes in the backward;
      - a decode step all-gathers every attention, MLA or cross-attention
        cache leaf whose time axis is sharded; with
        ``decode_attn="shard_map"`` an attention layer that
        ``parallel/decode_attn.py`` takes issues its max and two sums
        instead;
      - under an overlap mode other than ``gspmd_serial`` (collective
        backend), each MLP's up and gate projections add what
        :func:`repro_torch.parallel.collectives.counting` records around
        the FiCCO site (``parallel/tp.py::tp_ficco_linear``) at its local
        shapes on the ``"meta"`` device, on a group of the model axis's
        size.  The copy-engine backend's exchange is no collective.

    Every layer is counted, so nothing is extrapolated from shallower
    compiles: ``extrapolate`` and ``--no-extrapolate`` are accepted and
    change nothing.  XLA's ``raw_hlo_*``, ``lower_s`` and ``compile_s``
    have no counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import specs as specmod
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import CollectiveStats, counting
from repro_torch.parallel.sharding import (
    BATCH_AXES,
    MODEL_AXIS,
    P,
    TPGroup,
    axis_size,
    entry_axes,
    filter_pspec,
    map_specs,
    shard_shape,
    tp_group,
)
from repro_torch.parallel.tp import overlap_applicable, tp_ficco_linear
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import counters
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves

# Full-attention families run long_500k via their sliding-window variant;
# SSM/hybrid run it natively.
LONG_CONTEXT_WINDOW = 8192
# More parameters than this keep their Adam moments in bf16.  The
# reference's test multiplies the shape in int32 (``jnp.prod``), which
# wraps for Arctic's and Jamba's expert leaves, so its compiles keep those
# two in fp32 (ROADMAP R9); the port multiplies Python ints.
BF16_MOMENTS_ABOVE = 1e11
# The projections (a 2-D weight per layer, contracting dim first) that
# the tensor-parallel rules read; every other leaf is elementwise, a norm
# or the embedding (a lookup).  The MoE experts' 3-D weights take the
# all-to-all rule.
PROJECTIONS = frozenset({
    "wq", "wk", "wv", "wo", "w_dkv", "w_kr", "w_uk", "w_uv", "w_in", "w_x",
    "w_dt", "w_out", "w_up", "w_gate", "w_down", "w_if", "w_gates",
    "r_gates", "router", "unembed", "frontend_proj",
})


def prepared_config(arch: str, shape: ShapeConfig,
                    overlap: str) -> ModelConfig:
    cfg = get_config(arch)
    if shape.name == "long_500k" and cfg.family.value in (
        "dense", "moe", "vlm", "audio"
    ):
        cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    if overlap != "gspmd_serial":
        cfg = dataclasses.replace(
            cfg, overlap=dataclasses.replace(cfg.overlap, mode=overlap))
    return cfg


def _batch_axes(mesh) -> tuple:
    return tuple(a for a in BATCH_AXES if a in mesh.shape)


def _batch_specs(batch_shapes, mesh):
    """Each leaf's dim 0 over the batch axes when they divide it."""
    axes = _batch_axes(mesh)
    dp = math.prod(mesh.shape[a] for a in axes)

    def leaf(spec):
        rank = len(spec.shape)
        if dp > 1 and spec.shape[0] % dp == 0:
            return P(axes, *([None] * (rank - 1)))
        return P(*([None] * rank))

    return {k: leaf(v) for k, v in batch_shapes.items()}


def _activation_spec(shape, mesh, *entries) -> P:
    """``entries`` on ``mesh`` as the reference's ``constrain`` takes
    them: axes the mesh lacks dropped, and any entry whose axis size is 1
    or does not divide its dim."""
    spec = list(filter_pspec(P(*entries), mesh))
    spec += [None] * (len(shape) - len(spec))
    for i, e in enumerate(spec):
        size = axis_size(mesh, e)
        if e is not None and (size <= 1 or shape[i] % size):
            spec[i] = None
    return P(*spec)


def _spec_leaves(shapes, specs) -> list:
    """(shape, dtype, spec) of every leaf, walking the spec tree."""
    out: list = []
    map_specs(lambda sp, leaf: out.append(
        (tuple(leaf.shape), leaf.dtype, sp)), specs, shapes)
    return out


def shard_leaves(tree, mesh) -> list:
    """(shard shape, dtype) of every leaf of ``tree``, a dict of
    (shapes, specs) pairs (:func:`step_arguments`' form): one device's
    block of each."""
    return [(shard_shape(sp, shape, mesh), dtype)
            for shapes, specs in tree.values()
            for shape, dtype, sp in _spec_leaves(shapes, specs)]


def per_device_bytes(tree, mesh) -> int:
    return sum(math.prod(shape) * dtype.itemsize
               for shape, dtype in shard_leaves(tree, mesh))


def _moment_dtype(param_shapes) -> str:
    n = sum(math.prod(t.shape) for t in leaves(param_shapes))
    return "bfloat16" if n > BF16_MOMENTS_ABOVE else "float32"


def step_arguments(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """The step's arguments as ``{name: (shapes, specs)}``: shapes a tree
    of leaves with ``.shape`` and ``.dtype`` (meta tensors or
    :class:`~repro_torch.launch.specs.Spec`), specs its tree of :class:`P`
    fixed for ``mesh``.  ``train``: params, opt_state, batch;
    ``prefill``: params, the batch without its labels (the forward reads
    none, and ``jax.jit`` leaves an unread argument out of the reference's
    executable); ``decode``: params, cache, tokens, pos."""
    model = build_model(cfg)
    params = roofline.meta_state(cfg)
    pspecs = sharding.fix_param_specs(model.param_specs(), params, mesh)
    args = {"params": (params, pspecs)}
    if shape.kind in ("train", "prefill"):
        batch = specmod.train_specs(cfg, shape)
        if shape.kind == "prefill":
            del batch["labels"]
        else:
            mdt = getattr(torch, _moment_dtype(params))
            moments = map_specs(
                lambda sp, t: specmod.Spec(tuple(t.shape), mdt), pspecs,
                params)
            args["opt_state"] = (
                {"m": moments, "v": moments,
                 "step": specmod.Spec((), torch.int32)},
                opt.state_specs(pspecs))
        args["batch"] = (batch, _batch_specs(batch, mesh))
        return args
    dspec = specmod.decode_specs(cfg, shape, model)
    args["cache"] = (dspec["cache"], sharding.cache_specs(dspec["cache"],
                                                          mesh))
    args["tokens"] = (dspec["tokens"],
                      _batch_specs({"tokens": dspec["tokens"]},
                                   mesh)["tokens"])
    args["pos"] = (dspec["pos"], P())
    return args


def step_outputs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 args: dict) -> dict:
    """The step's outputs in :func:`step_arguments`' form: the new state
    for ``train``; the logits, and for ``decode`` the new cache."""
    if shape.kind == "train":
        return {k: args[k] for k in ("params", "opt_state")}
    b = shape.global_batch
    s = 1 if shape.is_decode else args["batch"][0]["tokens"].shape[1]
    logits = specmod.Spec((b, s, cfg.vocab_size),
                          getattr(torch, cfg.dtype))
    out = {"logits": (logits, _activation_spec(
        logits.shape, mesh, BATCH_AXES, None, MODEL_AXIS))}
    if shape.is_decode:
        out["cache"] = args["cache"]
    return out


# ---------------------------------------------------------------------------
# The collectives of an FSDP + tensor-parallel step, from the fixed specs
# ---------------------------------------------------------------------------

def _add(stats: CollectiveStats, kind: str, nbytes: float, count: int):
    if count <= 0:
        return
    stats.bytes_by_kind[kind] = stats.bytes_by_kind.get(kind, 0.0) + nbytes
    stats.count_by_kind[kind] = stats.count_by_kind.get(kind, 0) + count


def _has(entry, axis: str) -> bool:
    return axis in entry_axes(entry)


def _entries(spec: P, rank: int) -> list:
    return list(spec) + [None] * (rank - len(spec))


@dataclasses.dataclass
class _Step:
    """What the rules read of one step on one mesh."""

    cfg: ModelConfig
    mesh: Mesh
    kind: str
    b_local: int  # the batch rows on one device
    accum: int  # microbatches (training)
    batch_sharded: bool

    @property
    def train(self) -> bool:
        return self.kind == "train"

    def passes(self, *, recomputed: bool) -> tuple[int, int]:
        """(forward passes, backward passes) over a step: ``recomputed``
        for a period's or encoder layer's leaves, run again under
        ``remat`` (with ``remat_policy="dots"`` the products' outputs are
        kept, so the recomputation issues no collective)."""
        if not self.train:
            return 1, 0
        cfg = self.cfg
        again = recomputed and cfg.remat and cfg.remat_policy != "dots"
        return (2 if again else 1) * self.accum, self.accum

    def rows(self, per_row: int) -> int:
        """Tokens of one microbatch on one device, ``per_row`` a row."""
        return self.b_local // self.accum * per_row


def _weight(stats, st: _Step, name: str, leaf, spec: P, *, layers: int,
            tokens: int, used: bool = True):
    """The FSDP, tensor-parallel and gradient rules for one weight leaf.
    ``layers`` > 0: the leaf stacks that many layers on dim 0 (periods or
    encoder layers, recomputed under ``remat``); 0: a top-level leaf.
    ``tokens``: the tokens of one microbatch on one device that each use
    of a projection multiplies; ``used``: whether the step reads it."""
    mesh, item, shape = st.mesh, leaf.dtype.itemsize, tuple(leaf.shape)
    ents = _entries(spec, len(shape))
    per_layer, layer_ents = (shape[1:], ents[1:]) if layers else (shape,
                                                                  ents)
    calls = max(layers, 1)
    shard = math.prod(shard_shape(spec, shape, mesh)) * item
    data = mesh.shape.get("data", 1)
    fsdp = data > 1 and any(_has(e, "data") for e in ents)
    fwd, bwd = st.passes(recomputed=layers > 0)
    if used and fsdp:
        _add(stats, "all-gather", shard * data * (fwd + bwd),
             calls * (fwd + bwd))
    if used and name in PROJECTIONS and len(per_layer) == 2:
        d_in, d_out = per_layer
        if _has(layer_ents[0], MODEL_AXIS):  # row-parallel
            _add(stats, "all-reduce", fwd * calls * tokens * d_out * item,
                 fwd * calls)
        if bwd and _has(layer_ents[1], MODEL_AXIS):  # column-parallel
            _add(stats, "all-reduce", bwd * calls * tokens * d_in * item,
                 bwd * calls)
    if st.train:
        if fsdp:
            _add(stats, "reduce-scatter", shard, calls)
            if mesh.shape.get("pod", 1) > 1:
                _add(stats, "all-reduce", shard, calls)
        elif st.batch_sharded:
            _add(stats, "all-reduce", shard, calls)


def _weights(stats, st: _Step, shapes, specs, **kw):
    """:func:`_weight` over a dict of leaves and dicts."""
    for name, sub in shapes.items():
        if isinstance(sub, dict):
            _weights(stats, st, sub, specs[name], **kw)
        else:
            _weight(stats, st, name, sub, specs[name], **kw)


def _moe_all_to_all(stats, st: _Step, ffn_shapes, ffn_specs, layers: int,
                    tokens: int):
    """Dispatch and combine (and their transposes in the backward) of
    each MoE layer whose experts are sharded over ``model``: each call's
    output is this device's experts' capacity buffers."""
    moe = st.cfg.moe
    w = ffn_shapes["w_up"]  # (layers, E, d, f)
    e, d = w.shape[1], w.shape[2]
    if not _has(_entries(ffn_specs["w_up"], 4)[1], MODEL_AXIS):
        return
    g = st.mesh.shape[MODEL_AXIS]
    capacity = int(max(moe.capacity_factor * tokens * moe.top_k / e, 4))
    nbytes = -(-e // g) * capacity * d * w.dtype.itemsize
    fwd, bwd = st.passes(recomputed=True)
    calls = 2 * (fwd + bwd) * layers
    _add(stats, "all-to-all", calls * nbytes, calls)


def _ficco_site(stats, st: _Step, mlp: dict, layers: int,
                rows_per_seq: int):
    """The up (and gate) projections of ``layers`` MLPs (``mlp`` their
    stacked leaves) through the FiCCO site, counted around one call on
    the meta device."""
    ov = st.cfg.overlap
    g = st.mesh.shape.get(MODEL_AXIS, 1)
    if ov.mode == "gspmd_serial" or ov.backend != "collective" or g <= 1:
        return
    dt = getattr(torch, st.cfg.dtype)
    d, ff = mlp["w_up"].shape[-2:]
    x = torch.empty((st.b_local // st.accum, rows_per_seq, d), dtype=dt,
                    device="meta")
    w = torch.empty((d, ff), dtype=dt, device="meta")
    with tp_group(TPGroup(g, device="meta")):
        if not overlap_applicable(x, w):
            return
        with counting() as site:
            tp_ficco_linear(x, w, ov)
    fwd, _ = st.passes(recomputed=True)
    calls = len({"w_up", "w_gate"} & set(mlp)) * fwd * layers
    for kind, nbytes in site.bytes_by_kind.items():
        _add(stats, kind, calls * nbytes, calls * site.count_by_kind[kind])


_CACHE_READS = frozenset({"k", "v", "c_kv", "k_rope", "cross_k", "cross_v"})


def _cache_reads(stats, st: _Step, pattern, cache_shapes, cache_specs,
                 n_periods: int):
    """A decode step's reads of time-sharded attention caches."""
    cfg, mesh = st.cfg, st.mesh
    flash = cfg.overlap.decode_attn == "shard_map" and not cfg.sliding_window
    for layer, shapes, specs in zip(pattern, cache_shapes, cache_specs):
        for key, leaf in shapes.items():
            spec = specs[key]
            t_shards = axis_size(mesh, _entries(spec, len(leaf.shape))[2])
            if key not in _CACHE_READS or t_shards <= 1:
                continue
            if flash and layer.mixer == "attn" and key in ("k", "v"):
                if key == "k":  # the max, the denominator and the output
                    h, hd = cfg.num_heads, cfg.resolved_head_dim
                    _add(stats, "all-reduce",
                         n_periods * st.b_local * h * (2 + hd) * 4,
                         3 * n_periods)
                continue
            shard = math.prod(shard_shape(spec, leaf.shape, mesh))
            _add(stats, "all-gather",
                 n_periods * shard * t_shards * leaf.dtype.itemsize,
                 n_periods)


def step_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     args: dict, *, accum_steps: int = 1) -> CollectiveStats:
    """The collectives of one step, by the module docstring's rules.
    Bytes are each call's output on one device, as
    :func:`~repro_torch.parallel.collectives.counting` and the reference's
    ``parse_collectives`` count them."""
    stats = CollectiveStats({}, {})
    if mesh.size <= 1:
        return stats
    model = build_model(cfg)
    params, pspecs = args["params"]
    axes = _batch_axes(mesh)
    dp = math.prod(mesh.shape[a] for a in axes)
    b = shape.global_batch
    batch_sharded = dp > 1 and b % dp == 0
    decode = shape.is_decode
    s_text, prefix, s_enc = 1, 0, 0
    if not decode:
        batch = args["batch"][0]
        s_text = batch["tokens"].shape[1]
        if "prefix_embeds" in batch:
            prefix = batch["prefix_embeds"].shape[1]
        if "enc_frames" in batch:
            s_enc = batch["enc_frames"].shape[1]
    accum = accum_steps if shape.kind == "train" else 1
    st = _Step(cfg, mesh, shape.kind, b // dp if batch_sharded else b,
               accum, batch_sharded)
    if st.b_local % accum:
        raise ValueError(f"{accum} microbatches do not divide the "
                         f"{st.b_local} rows on a device")
    text, dec, enc = st.rows(s_text), st.rows(s_text + prefix), st.rows(s_enc)

    # The embedding: a lookup over its vocab shards, and, tied, the
    # unembedding (its transpose, column-parallel).
    emb = params["embed"]
    _weight(stats, st, "embed", emb, pspecs["embed"], layers=0, tokens=0)
    fwd, bwd = st.passes(recomputed=False)
    vocab_sharded = _has(pspecs["embed"][0], MODEL_AXIS)
    if vocab_sharded:
        row = text * emb.shape[1] * emb.dtype.itemsize
        _add(stats, "all-reduce", fwd * row, fwd)
        if cfg.tie_embeddings:
            _add(stats, "all-reduce", bwd * row, bwd)
    if "unembed" in params:
        _weight(stats, st, "unembed", params["unembed"], pspecs["unembed"],
                layers=0, tokens=text)
        vocab_sharded = _has(_entries(pspecs["unembed"], 2)[1], MODEL_AXIS)
    if st.train and vocab_sharded:  # the loss's max, sum and gold logit
        _add(stats, "all-reduce", 3 * fwd * text * 4, 3 * fwd)
    for name in ("final_norm", "enc_norm"):
        if name in params:
            _weights(stats, st, params[name], pspecs[name], layers=0,
                     tokens=0, used=not decode or name == "final_norm")
    if "frontend_proj" in params:
        _weight(stats, st, "frontend_proj", params["frontend_proj"],
                pspecs["frontend_proj"], layers=0, tokens=st.rows(prefix),
                used=not decode)

    n = model.n_periods
    for layer, shapes, specs in zip(model.pattern, params["layers"],
                                    pspecs["layers"]):
        for part, sub in shapes.items():
            if part == "cross":  # wk / wv read the encoder (cached)
                for name, leaf in sub.items():
                    on_enc = name in ("wk", "wv")
                    _weight(stats, st, name, leaf, specs[part][name],
                            layers=n, tokens=enc if on_enc else dec,
                            used=not (decode and on_enc))
                continue
            if part == "ffn" and layer.ffn == "moe":
                _moe_all_to_all(stats, st, sub, specs[part], n, dec)
            _weights(stats, st, sub, specs[part], layers=n, tokens=dec)
        if not decode and layer.ffn != "none":
            ffn = shapes["ffn"]
            mlps = [ffn] if layer.ffn == "mlp" else [
                ffn[k] for k in ("shared", "dense_residual") if k in ffn]
            for mlp in mlps:
                _ficco_site(stats, st, mlp, n, s_text + prefix)
    if "encoder" in params:
        n_enc = cfg.encdec.encoder_layers
        _weights(stats, st, params["encoder"], pspecs["encoder"],
                 layers=n_enc, tokens=enc, used=not decode)
        if not decode:
            _ficco_site(stats, st, params["encoder"]["ffn"], n_enc, s_enc)
    if decode:
        _cache_reads(stats, st, model.pattern, *args["cache"], n)
    return stats


# ---------------------------------------------------------------------------
# The dry-run
# ---------------------------------------------------------------------------

def dryrun_one(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    overlap: str = "gspmd_serial",
    verbose: bool = True,
    extrapolate: bool = True,
    transform=None,
    accum_steps: int = 1,
) -> dict:
    """One pair's roofline, ``Roofline.to_dict()`` with ``overlap``,
    ``ok``, ``argument_bytes`` and ``output_bytes``.  ``transform`` maps
    the prepared config (the hillclimb's variants); ``extrapolate`` has no
    effect (every layer is counted)."""
    del extrapolate
    shape = SHAPES[shape_name]
    cfg = prepared_config(arch, shape, overlap)
    if transform is not None:
        cfg = transform(cfg)
    mesh = make_production_mesh(multi_pod=multi_pod)
    args = step_arguments(cfg, shape, mesh)
    arg_bytes = per_device_bytes(args, mesh)
    out_bytes = per_device_bytes(step_outputs(cfg, shape, mesh, args), mesh)
    coll = step_collectives(cfg, shape, mesh, args, accum_steps=accum_steps)
    rf = roofline.analyze(
        arch=arch,
        shape=shape_name,
        mesh_name=mesh.name,
        chips=mesh.size,
        costs=counters.step_costs(cfg, shape, shape.kind),
        collectives=coll,
        model_flops=roofline.model_flops_for(cfg, shape, shape.kind),
        bytes_per_device=arg_bytes + out_bytes,
    )
    result = rf.to_dict()
    result.update(overlap=overlap, ok=True, argument_bytes=arg_bytes,
                  output_bytes=out_bytes)
    if verbose:
        print(f"== {arch} x {shape_name} ({result['mesh']}, {overlap}) ==")
        print(f"per device: arguments {arg_bytes / 1e9:.3f} GB, outputs "
              f"{out_bytes / 1e9:.3f} GB")
        print(
            f"cost: flops={result['hlo_flops']:.3e} "
            f"bytes={result['hlo_bytes']:.3e} "
            f"collective_bytes={result['collective_bytes']:.3e} "
            f"counts={result['collective_counts']}"
        )
        print(
            f"roofline: compute={rf.t_compute*1e3:.2f}ms "
            f"memory={rf.t_memory*1e3:.2f}ms "
            f"collective={rf.t_collective*1e3:.2f}ms "
            f"dominant={rf.dominant} "
            f"useful={rf.useful_flops_ratio:.2f}"
        )
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--overlap-mode", default="gspmd_serial")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="accepted for the reference's command line; every "
                    "layer is counted, so it changes nothing")
    args = ap.parse_args(argv)

    runs = []
    if args.all:
        for arch in sorted(ARCHS):
            for shape in SHAPES:
                runs.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        runs.append((args.arch, args.shape))

    results = []
    for arch, shape in runs:
        try:
            results.append(dryrun_one(
                arch, shape,
                multi_pod=args.multi_pod,
                overlap=args.overlap_mode,
                extrapolate=not args.no_extrapolate,
            ))
        except Exception as e:
            traceback.print_exc()
            results.append(
                {"arch": arch, "shape": shape, "ok": False, "error": str(e)})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if not r.get("ok")]
    print(f"\n{len(results) - len(bad)}/{len(results)} dry-runs passed")
    return 1 if bad else 0


__all__ = ["LONG_CONTEXT_WINDOW", "prepared_config", "step_arguments",
           "step_outputs", "step_collectives", "shard_leaves",
           "per_device_bytes", "dryrun_one", "main"]


if __name__ == "__main__":
    raise SystemExit(main())
