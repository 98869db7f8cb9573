"""Tensor-parallel group and the stacked-rank sharding layout.

The reference runs tensor parallelism under an ambient JAX mesh with a
``"model"`` axis (``repro.parallel.sharding``).  The port holds the same
group as a :class:`TPGroup` of ``size`` logical ranks on one device,
entered with :func:`tp_group` and read back with :func:`active_group`.

A sharded tensor is stacked on a leading rank dim, in the order
``shard_map`` cuts it: ``shard_rows`` is ``P("model", None)`` (rank r holds
row block r) and ``shard_columns`` is ``P(None, "model")`` (rank r holds
column block r).  ``shard_columns`` is a strided view, so a weight is
never copied to be sharded; the kernels read each rank's columns in place.

The launch-time specs follow (``repro.parallel.sharding:81-205``, rule for
rule): :class:`P`, the port's partition spec, with ``BATCH_AXES`` and
``MODEL_AXIS``; :func:`fix_param_spec` (divisibility, then FSDP over
``data``) and :func:`cache_leaf_spec` (the decode cache's rule), with
their tree versions; and :func:`shard_shape`, one device's block of a
leaf.  They read nothing of a mesh but ``mesh.shape``, an ordered mapping
of axis name to size (:class:`repro_torch.launch.mesh.Mesh`).  The tree
versions call :func:`fix_param_spec` and :func:`cache_leaf_spec` through
this module's globals, so a variant can replace them here
(``repro_torch.scripts.hillclimb``).  The reference's ``constrain`` and
``_active_mesh`` have no counterpart: there is no partitioner to
constrain.  A group whose ranks are processes
(:class:`~repro_torch.parallel.group.RankGroup`) holds each rank's blocks
in its own process instead; :func:`shard_params` cuts a model's state to
one rank's blocks and :func:`shard_train_state` a train state, by the one
rule of :func:`block_dim`: a leaf is cut where its spec, fixed for a
model-only mesh of the group's size, names the model axis (ROADMAP A9).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch

from repro_torch.device import resolve_device
from repro_torch.tree import leaves

_STATE = threading.local()
# Copy streams a group's chunk exchange spreads its copies over, at most one
# per rank: as many as an H100 has copy engines.  chip_smoke.py times the
# exchange on 1-4 streams (PERF.md): one stream per engine gave the
# steadiest device time, and more streams cost the host more to issue.
COPY_STREAMS = 3


class CopyStreams:
    """A group's copy streams, for a class with ``size`` and ``device``.

    On CUDA the group owns the copy streams that the chunk exchange runs
    on, apart from the compute stream that runs the step GEMMs:
    ``COPY_STREAMS`` of them, at most one per rank, made at first use.
    The exchange is issued on the first and spread over the others, which
    are forked from it and joined back.
    """

    _copy_streams: tuple = ()

    @property
    def copy_streams(self) -> tuple:
        """The dedicated copy streams (CUDA only; ``()`` on the CPU)."""
        if self.device.type != "cuda":
            return ()
        if not self._copy_streams:
            self._copy_streams = tuple(
                torch.cuda.Stream(device=self.device)
                for _ in range(min(self.size, COPY_STREAMS))
            )
        return self._copy_streams

    @property
    def copy_stream(self):
        """The first copy stream (CUDA only; ``None`` on the CPU)."""
        streams = self.copy_streams
        return streams[0] if streams else None


class TPGroup(CopyStreams):
    """``size`` logical tensor-parallel ranks held on one device, with
    the copy streams of :class:`CopyStreams`."""

    peers = None  # its ranks share one process: no memory to export

    def __init__(self, size: int, device=None):
        if size < 1:
            raise ValueError(f"group size must be >= 1, got {size}")
        self.size = int(size)
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"TPGroup(size={self.size}, device={str(self.device)!r})"


def active_group() -> TPGroup | None:
    return getattr(_STATE, "group", None)


@contextlib.contextmanager
def tp_group(group: TPGroup | None):
    """Make ``group`` the active tensor-parallel group inside the block."""
    prev = active_group()
    _STATE.group = group
    try:
        yield group
    finally:
        _STATE.group = prev


def shard_rows(x: torch.Tensor, g: int) -> torch.Tensor:
    """``P("model", None, ...)``: (n, ...) -> (g, n/g, ...) view."""
    if x.shape[0] % g:
        raise ValueError(f"dim 0 of {tuple(x.shape)} not divisible by {g}")
    return x.view(g, x.shape[0] // g, *x.shape[1:])


def shard_columns(w: torch.Tensor, g: int) -> torch.Tensor:
    """``P(None, "model")``: (k, n) -> (g, k, n/g) strided view."""
    k, n = w.shape
    if n % g:
        raise ValueError(f"dim 1 of {tuple(w.shape)} not divisible by {g}")
    return w.view(k, g, n // g).permute(1, 0, 2)


def block_dim(spec) -> int | None:
    """The dim on which a rank of a group of processes holds only its
    block of a leaf whose fixed spec is ``spec``: the dim whose entry
    names ``MODEL_AXIS``, or None where the rank holds the leaf whole.
    ``spec`` comes from :meth:`Model.rank_specs
    <repro_torch.models.model.Model.rank_specs>`: the reference's
    ``param_specs`` through :func:`fix_param_spec` on a model-only mesh
    of the group's size, so a dim the group does not divide stays whole.
    The one rule of :func:`shard_params`, :func:`shard_train_state` and
    :func:`rank_blocks`, which the optimizer's global norm reads."""
    for i, entry in enumerate(spec):
        if MODEL_AXIS in entry_axes(entry):
            return i
    return None


def _map_blocks(fn, tree, specs):
    """``fn(leaf, dim)`` over a tree's leaves, ``dim`` the
    :func:`block_dim` of the leaf's spec in ``specs`` (a tree of
    :class:`P` over the tree's structure); a tree like ``tree``."""
    if isinstance(tree, dict):
        return {k: _map_blocks(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_blocks(fn, v, s)
                for v, s in zip(tree, specs, strict=True)]
    return fn(tree, block_dim(specs))


def rank_blocks(tree, specs) -> list[bool]:
    """For each leaf of ``tree`` in :func:`repro_torch.tree.leaves` order,
    whether a rank holds only its block of it (:func:`block_dim` of its
    spec in ``specs``)."""
    return leaves(_map_blocks(lambda t, dim: dim is not None, tree, specs))


def take_block(t, dim: int, rank: int, size: int):
    """Block ``rank`` of ``size`` of ``t`` (a tensor or a numpy array)
    along ``dim``, a contiguous copy."""
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} not divisible "
                         f"by {size}")
    b = n // size
    block = t[(slice(None),) * dim + (slice(rank * b, (rank + 1) * b),)]
    if isinstance(block, torch.Tensor):
        return block.clone(memory_format=torch.contiguous_format)
    return block.copy()


def shard_params(tree, specs, rank: int, size: int):
    """Rank ``rank``'s copy of a model's state for a group of ``size``
    processes: each leaf whose spec in ``specs`` (:meth:`Model.rank_specs
    <repro_torch.models.model.Model.rank_specs>` for ``size``) names the
    model axis, cut to its block r on that dim (:func:`block_dim`); every
    other leaf as it is.  The blocks are copies, so the full weights can
    be freed."""
    return _map_blocks(
        lambda t, dim: t if dim is None else take_block(t, dim, rank, size),
        tree, specs)


def shard_train_state(state, specs, rank: int, size: int):
    """Rank ``rank``'s copy of a train state ``{"params", "opt_state":
    {"m", "v", "step"}}``: the params and AdamW's ``m`` and ``v`` cut by
    :func:`shard_params` with the params' ``specs``, ``step`` as it
    is."""
    opt_state = state["opt_state"]
    return {
        "params": shard_params(state["params"], specs, rank, size),
        "opt_state": {
            **opt_state,
            "m": shard_params(opt_state["m"], specs, rank, size),
            "v": shard_params(opt_state["v"], specs, rank, size),
        },
    }


# ---------------------------------------------------------------------------
# Launch-time partition specs
# ---------------------------------------------------------------------------

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one entry per leading dim of a leaf, each ``None``
    (replicated), a mesh axis name, or a tuple of names (the dim split
    over their product); dims past the last entry are replicated.  A tuple
    of its entries, as ``jax.sharding.PartitionSpec`` iterates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):  # pickle and copy rebuild P(*entries)
        return tuple(self)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


def map_specs(fn, specs, *rest):
    """``fn(spec, *leaves)`` over a tree of :class:`P` (dicts and lists)
    and trees of its structure (``jax.tree.map`` with ``P`` as a leaf)."""
    if isinstance(specs, P):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(specs)]
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def _filter_spec(spec: P, axis_names) -> P:
    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in axis_names else None
        sub = tuple(a for a in entry if a in axis_names)
        return sub if sub else None

    return P(*(keep(e) for e in spec))


def batch_spec(*rest) -> tuple:
    """Spec entries for a (batch, ...) activation."""
    return (BATCH_AXES, *rest)


def filter_pspec(spec: P, mesh) -> P:
    """Drop the axes ``mesh`` lacks from ``spec``."""
    return _filter_spec(spec, set(mesh.shape))


def axis_size(mesh, entry) -> int:
    """The number of blocks a spec entry cuts its dim into on ``mesh``."""
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape.get(entry, 1)
    n = 1
    for a in entry:
        n *= mesh.shape.get(a, 1)
    return n


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def fix_param_spec(spec: P, shape, mesh, *, fsdp_axis: str = "data") -> P:
    """Make a parameter spec legal and memory-efficient on ``mesh``:

      1. drop axes the mesh doesn't have,
      2. drop entries whose dimension is not divisible by the axis size
         (e.g. seamless's 256206 vocab over a 16-way axis),
      3. FSDP: if the ``data`` axis is unused and the leaf is a real weight
         (>= 2 dims, >= 2^16 elements), shard its largest divisible,
         not-yet-sharded dimension over ``data`` (ZeRO-3-style 2D weight
         sharding, which keeps 400B-class models' parameters and moments
         within a device's memory at 256 devices).
    """
    names = set(mesh.shape)
    spec = _filter_spec(spec, names)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used: set[str] = set()
    for i, e in enumerate(entries):
        if e is None:
            continue
        if shape[i] % axis_size(mesh, e):
            entries[i] = None
            continue
        used.update(entry_axes(e))
    n_elems = math.prod(shape) if shape else 1
    if (
        fsdp_axis in names
        and fsdp_axis not in used
        and len(shape) >= 2
        and n_elems >= 1 << 16
    ):
        ax = mesh.shape[fsdp_axis]
        candidates = [
            i
            for i in range(len(shape))
            if entries[i] is None and shape[i] % ax == 0 and shape[i] >= ax
        ]
        if candidates:
            best = max(candidates, key=lambda i: shape[i])
            entries[best] = fsdp_axis
    return P(*entries)


def fix_param_specs(specs, shapes, mesh):
    """Tree version of :func:`fix_param_spec`: ``shapes`` is a tree of the
    specs' structure whose leaves have a ``.shape`` (meta tensors or
    :class:`repro_torch.launch.specs.Spec`)."""
    return map_specs(
        lambda sp, leaf: fix_param_spec(sp, tuple(leaf.shape), mesh),
        specs, shapes)


def cache_leaf_spec(shape, mesh) -> P:
    """Decode-cache sharding rule.

    Layout (periods, B, ...): batch over (pod, data) when divisible; the
    largest remaining dimension >= 1024 divisible by the model axis is
    sharded over 'model' (the 32k KV time axis, or Mamba's d_inner);
    when batch is unsharded (long_500k B=1) the 'data' axis joins the
    sequence dimension: context-parallel cache reads.
    """
    names = set(mesh.shape)
    rank = len(shape)
    entries: list = [None] * rank
    dp = 1
    batch_axes = tuple(a for a in BATCH_AXES if a in names)
    for a in batch_axes:
        dp *= mesh.shape[a]
    batch_sharded = False
    if rank >= 2 and dp > 1 and shape[1] % dp == 0 and shape[1] >= dp:
        entries[1] = batch_axes if len(batch_axes) > 1 else batch_axes[0]
        batch_sharded = True
    model = mesh.shape.get(MODEL_AXIS, 1)
    rest = sorted(range(2, rank), key=lambda i: shape[i], reverse=True)
    for i in rest:
        if model > 1 and shape[i] >= 1024 and shape[i] % model == 0:
            if not batch_sharded and dp > 1 and shape[i] % (model * dp) == 0:
                entries[i] = (*batch_axes, MODEL_AXIS)
            else:
                entries[i] = MODEL_AXIS
            break
    return P(*entries)


def cache_specs(cache_shapes, mesh):
    """:func:`cache_leaf_spec` over a cache tree (dicts and lists whose
    leaves have a ``.shape``)."""
    if isinstance(cache_shapes, dict):
        return {k: cache_specs(v, mesh) for k, v in cache_shapes.items()}
    if isinstance(cache_shapes, list):
        return [cache_specs(v, mesh) for v in cache_shapes]
    return cache_leaf_spec(tuple(cache_shapes.shape), mesh)


def shard_shape(spec: P, shape, mesh) -> tuple:
    """One device's block of a leaf of ``shape`` under ``spec`` on
    ``mesh``: each dim over its entry's axis size, rounded up, as XLA pads
    an uneven block (the fixed specs above leave none)."""
    entries = list(filter_pspec(spec, mesh)) + [None] * len(shape)
    return tuple(-(-n // axis_size(mesh, e)) for n, e in zip(shape, entries))


__all__ = [
    "BATCH_AXES",
    "MODEL_AXIS",
    "P",
    "map_specs",
    "batch_spec",
    "filter_pspec",
    "axis_size",
    "entry_axes",
    "fix_param_spec",
    "fix_param_specs",
    "cache_leaf_spec",
    "cache_specs",
    "shard_shape",
    "COPY_STREAMS",
    "CopyStreams",
    "TPGroup",
    "active_group",
    "tp_group",
    "shard_rows",
    "shard_columns",
    "block_dim",
    "rank_blocks",
    "take_block",
    "shard_params",
    "shard_train_state",
]
