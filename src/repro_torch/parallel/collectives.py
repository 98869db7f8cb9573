"""Collectives of a tensor-parallel group: over the stacked rank dim of a
logical group, or across the processes of a :class:`RankGroup`.

The reference's schedules call ``lax.all_gather``, ``lax.ppermute`` and
``lax.all_to_all`` inside ``shard_map``; XLA lowers them to transfers
between devices.  A :class:`~repro_torch.parallel.sharding.TPGroup` holds
its ranks on one device, stacked on dim 0, so each collective here
materialises every rank's copy of the result: the bytes move as the
collective would move them, and no rank reads another rank's slot
afterwards.  Given ``group=`` a :class:`RankGroup`, each takes this
rank's own block, with no leading rank dim, and runs as a
``torch.distributed`` call on the group's plain process group (gloo on
the CPU, NCCL with a card per rank; ranks sharing a card raise, ROADMAP
A9): the per-rank form of a ``shard_map`` body's collective.  NCCL takes
the CUDA tensors where they lie and orders its work after the caller's
current stream; no collective copies through the host.  The per-rank
forms have gradients (``pmax`` excepted), the transposes ``jax.grad``
takes through ``shard_map``: an all-gather's is :func:`psum_scatter`
(``lax.psum_scatter``) and the other way round; :func:`rank_block` and
:func:`replicated`
carry a replicated activation's gradient across the group where a rank
cuts its block out of it or multiplies it by its own weight block, and
:func:`gather_replicated`, the transpose of :func:`rank_block`, gathers
the rank's block of a result that every rank then uses alike.

:func:`counting` records what the collectives move, as the reference's
``roofline.analysis.parse_collectives`` reads it from a compiled per-device
program: each call's output bytes on one rank, by the HLO kind name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch
import torch.distributed as dist

from repro_torch.parallel.group import RankGroup

# Later torch releases deprecate ``all_gather_into_tensor`` and
# ``reduce_scatter_tensor`` for ``*_single`` forms, which earlier ones
# lack; every release takes the calls used here.
warnings.filterwarnings(
    "ignore", message=r"`torch\.distributed\.(all_gather_into_tensor|"
    r"reduce_scatter_tensor)` is deprecated", category=FutureWarning)


@dataclasses.dataclass
class CollectiveStats:
    """Bytes and calls by kind (``all-gather``, ``all-to-all``,
    ``collective-permute``, ``all-reduce``, ``reduce-scatter``), each
    call's bytes its output on one rank."""

    bytes_by_kind: dict[str, float]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


_ACTIVE: CollectiveStats | None = None


@contextlib.contextmanager
def counting():
    """Count the collectives called inside the block; yields the
    :class:`CollectiveStats` they add to.

    Each :func:`all_gather`, :func:`all_to_all`, :func:`ppermute`,
    :func:`all_reduce`, :func:`pmax` and :func:`psum_scatter` call adds
    its per-rank output bytes (a stacked
    output's over the group size; a :class:`RankGroup` rank's own) under
    the reference's HLO kind.  Two things are not counted:
    a collective the autograd engine runs in a backward (the
    recomputation of a ``remat`` period included), and K3's and K4's
    exchanges, which are Pallas DMAs in the reference and no HLO
    collective.
    """
    global _ACTIVE
    outer, stats = _ACTIVE, CollectiveStats({}, {})
    _ACTIVE = stats
    try:
        yield stats
    finally:
        _ACTIVE = outer


def _record(kind: str, out: torch.Tensor, ranks: int | None = None
            ) -> torch.Tensor:
    """Count ``out`` under ``kind``: its bytes over ``ranks`` (by default
    its leading, stacked rank dim)."""
    stats = _ACTIVE
    if stats is not None and torch._C._current_graph_task_id() == -1:
        ranks = out.shape[0] if ranks is None else ranks
        nbytes = float(out.numel() // ranks * out.element_size())
        stats.bytes_by_kind[kind] = stats.bytes_by_kind.get(kind, 0.0) + nbytes
        stats.count_by_kind[kind] = stats.count_by_kind.get(kind, 0) + 1
    return out


def _plain(group: RankGroup):
    if not isinstance(group, RankGroup):
        raise TypeError(f"group= takes a RankGroup, not {group!r}; a logical "
                        "TPGroup's collectives take the stacked ranks")
    return group.plain


# The per-rank forms run on the group's plain process group.  Each is a
# torch.autograd.Function whose backward is the transpose that
# ``jax.grad`` takes through a ``shard_map`` body: the all-gather's is a
# reduce-scatter, the all-to-all's an all-to-all, a ppermute's the ppermute
# back, and a psum's the identity (the cotangent of a replicated output is
# replicated already; summing it again would scale it by g).  Collectives
# that run in a backward are not counted (``_record``).

def _gather(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """(m, ...) -> (g, m, ...), every rank's block in rank order."""
    out = torch.empty((group.size, *x.shape), dtype=x.dtype, device=x.device)
    # The concatenated form, which gloo takes as well as NCCL.
    dist.all_gather_into_tensor(out.flatten(0, 1), x.contiguous(),
                                group=_plain(group))
    return out


def _reduce_scatter(dy: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """(g, m, ...) on every rank -> (m, ...): block r of the sum over
    ranks, on rank r."""
    out = torch.empty(dy.shape[1:], dtype=dy.dtype, device=dy.device)
    dist.reduce_scatter_tensor(out, dy.contiguous().flatten(0, 1),
                               group=_plain(group))
    return out


def _scatter_along(x: torch.Tensor, dim: int, group: RankGroup
                   ) -> torch.Tensor:
    """Block r of the sum over ranks of ``x`` along ``dim``, on rank r."""
    blocks = x.movedim(dim, 0)
    blocks = blocks.reshape(group.size, -1, *blocks.shape[1:])
    return _reduce_scatter(blocks, group).movedim(0, dim)


def _gather_along(x: torch.Tensor, dim: int, group: RankGroup
                  ) -> torch.Tensor:
    """Every rank's block ``x`` joined along ``dim`` in rank order."""
    return _gather(x, group).movedim(0, dim).flatten(dim, dim + 1)


def _exchange(x: torch.Tensor, group: RankGroup, async_op: bool = False):
    if x.shape[0] != group.size:
        raise ValueError(f"all_to_all of {tuple(x.shape)}: dim 0 must be "
                         "the group size")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    work = dist.all_to_all_single(out, x.contiguous(), group=_plain(group),
                                  async_op=async_op)
    return out, work


def _permute(x: torch.Tensor, shift: int, group: RankGroup) -> torch.Tensor:
    g, r = group.size, group.rank
    x = x.contiguous()
    out = torch.empty_like(x)
    if shift % g == 0:
        out.copy_(x)
        return out
    pg = _plain(group)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, (r + shift) % g, pg),
        dist.P2POp(dist.irecv, out, (r - shift) % g, pg),
    ])
    for req in reqs:
        req.wait()
    return out


def _sum(x: torch.Tensor, group: RankGroup, op=dist.ReduceOp.SUM):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=_plain(group))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _record("all-gather", _gather(x, group), ranks=1)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.group), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _record("reduce-scatter", _scatter_along(x, dim, group),
                       ranks=1)

    @staticmethod
    def backward(ctx, dy):
        return _gather_along(dy, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _record("all-to-all", _exchange(x, group)[0], ranks=1)

    @staticmethod
    def backward(ctx, dy):
        return _exchange(dy, ctx.group)[0], None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _record("collective-permute", _permute(x, shift, group),
                       ranks=1)

    @staticmethod
    def backward(ctx, dy):
        return _permute(dy, -ctx.shift, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _record("all-reduce", _sum(x, group), ranks=1)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _RankBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // group.size
        return x.narrow(dim, group.rank * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, dy):
        full = _gather(dy, ctx.group)  # (g, *block)
        return full.movedim(0, ctx.dim).flatten(ctx.dim, ctx.dim + 1), \
            None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        out = _record("all-gather", _gather(x, group), ranks=1)
        return out.movedim(0, dim).flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, dy):
        n = dy.shape[ctx.dim] // ctx.group.size
        return dy.narrow(ctx.dim, ctx.group.rank * n, n).contiguous(), \
            None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.group), None


def all_gather(x: torch.Tensor, *, tiled: bool = False, axis: int = 0,
               group: RankGroup | None = None) -> torch.Tensor:
    """``lax.all_gather(x, axis=axis[, tiled])`` on every rank.

    x: (g, m, ...), rank r's block at [r].  Untiled -> (g, g, m, ...),
    out[r, s] = x[s]; tiled -> (g, g * m, ...), the blocks concatenated
    in rank order on every rank (along the block's dim ``axis``, which
    untiled must be 0).  With ``group``: x is this rank's (m, ...) block
    -> (g, m, ...), or tiled the blocks joined along ``axis``; its
    gradient is the reduce-scatter of the output's
    (:func:`psum_scatter`), as the gathered tensor feeds a computation
    that differs by rank.
    """
    if axis and not tiled:
        raise ValueError("all_gather along an axis other than 0 is tiled")
    if group is not None:
        out = _AllGather.apply(x, group)
        if not tiled:
            return out
        axis %= x.dim()
        return out.movedim(0, axis).flatten(axis, axis + 1)
    g = x.shape[0]
    out = _record("all-gather", x.unsqueeze(0).expand(g, *x.shape)
                  .contiguous())
    if tiled:
        axis = axis % (x.dim() - 1) + 1
        return out.movedim(1, axis).flatten(axis, axis + 1)
    return out


def psum_scatter(x: torch.Tensor, dim: int, *,
                 group: RankGroup | None = None) -> torch.Tensor:
    """``lax.psum_scatter(x, scatter_dimension=dim, tiled=True)``: block r
    along ``dim`` of the sum of every rank's ``x``, on rank r.

    x: (g, ...), rank r's addend at [r] -> (g, ...) with ``dim`` of the
    addend cut g-fold.  With ``group``: x is this rank's addend -> its
    block; the gradient is the all-gather of the output's along ``dim``,
    every rank's block of the cotangent joined (the transpose of
    :func:`all_gather`).  Counted under ``reduce-scatter``.
    """
    if group is not None:
        return _PsumScatter.apply(x, dim % x.dim(), group)
    g = x.shape[0]
    dim = dim % (x.dim() - 1)
    total = x.sum(0).movedim(dim, 0)
    blocks = total.reshape(g, -1, *total.shape[1:]).movedim(1, dim + 1)
    return _record("reduce-scatter", blocks.contiguous())


def all_to_all(x: torch.Tensor, *, group: RankGroup | None = None
               ) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0)`` on every rank.

    x: (g, g, ...), rank r's block s at [r, s] -> (g, g, ...): rank r's
    block s lands in rank s's slot r, out[s, r] = x[r, s], a copy.  With
    ``group``: x is this rank's (g, ...) blocks -> (g, ...), out[s] rank
    s's block for this rank; its gradient is the all-to-all of the
    output's.
    """
    if group is not None:
        return _AllToAll.apply(x, group)
    if x.shape[1] != x.shape[0]:
        raise ValueError(f"all_to_all of {tuple(x.shape)}: dim 1 must be "
                         "the group size")
    return _record("all-to-all", x.transpose(0, 1).contiguous())


def all_to_all_start(x: torch.Tensor, *, group: RankGroup):
    """:func:`all_to_all` with ``group``, issued and not waited for:
    returns (out, work).  ``out`` must not be read before ``work.wait()``,
    which, on NCCL, makes the caller's current stream wait for the
    exchange (the host does not block); NCCL orders the exchange after
    the work already on that stream when it is issued.  No gradient: the
    EP dispatch's overlapped form (:mod:`repro_torch.overlap.moe`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("all_to_all_start has no reverse-mode rule; "
                           "use all_to_all(group=) under grad")
    out, work = _exchange(x, group, async_op=True)
    return _record("all-to-all", out, ranks=1), work


def ppermute(x: torch.Tensor, shift: int = 1, *,
             group: RankGroup | None = None) -> torch.Tensor:
    """``lax.ppermute`` with ``perm = [(i, (i + shift) % g)]``: rank r
    receives rank (r - shift)'s block.  x: (g, ...) -> (g, ...), a copy.
    With ``group``: x is this rank's block, sent to rank r + shift while
    rank r - shift's is received (one ``batch_isend_irecv``); its gradient
    is the ppermute by ``-shift`` of the output's."""
    if group is not None:
        return _Ppermute.apply(x, shift, group)
    g = x.shape[0]
    src = (torch.arange(g, device=x.device) - shift) % g
    return _record("collective-permute", x[src])


def all_reduce(x: torch.Tensor, *, group: RankGroup,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``lax.psum`` over a :class:`RankGroup`: the sum of every rank's
    ``x`` (``op`` another reduction), the same bits on every rank (a copy;
    ``x`` is unchanged).  The sum's gradient is the output's, unchanged:
    the output is replicated, so its cotangent already is.  Another
    ``op`` refuses grad."""
    if op == dist.ReduceOp.SUM:
        return _AllReduce.apply(x, group)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"all_reduce with {op} has no reverse-mode rule")
    return _record("all-reduce", _sum(x, group, op), ranks=1)


def pmax(x: torch.Tensor, *, group: RankGroup) -> torch.Tensor:
    """``lax.pmax`` over a :class:`RankGroup`: the elementwise max of every
    rank's ``x``, counted under ``all-reduce`` as XLA lowers it.  Decode
    only: refuses grad."""
    return all_reduce(x, group=group, op=dist.ReduceOp.MAX)


def rank_block(x: torch.Tensor, dim: int, *, group: RankGroup
               ) -> torch.Tensor:
    """This rank's block r of the replicated ``x`` along ``dim`` (a copy),
    as ``shard_map`` cuts a replicated operand.  Its gradient is the full
    ``x``'s: the blocks' cotangents all-gathered, the same bits on every
    rank, so the replicated computation upstream gets the gradient it
    would in one process.  No collective in the forward."""
    return _RankBlock.apply(x, dim % x.dim(), group)


def gather_replicated(x: torch.Tensor, dim: int, *, group: RankGroup
                      ) -> torch.Tensor:
    """Every rank's block ``x`` joined along ``dim`` in rank order (one
    all-gather), for a computation that every rank then does alike: the
    transpose of :func:`rank_block`.  The output's cotangent is then the
    same on every rank, so the gradient is this rank's block of it, not
    the reduce-scatter of :func:`all_gather`'s backward, which would sum
    the g equal copies into g times the block's gradient."""
    return _GatherReplicated.apply(x, dim % x.dim(), group)


def replicated(x: torch.Tensor, *, group: RankGroup) -> torch.Tensor:
    """``x``, a replicated operand of this rank's partial product (a
    column block's GEMM): the forward is the identity, the gradient the
    sum of every rank's cotangent (an all-reduce), as the rank's own is
    only its block's part."""
    return _Replicated.apply(x, group)


__all__ = ["CollectiveStats", "counting", "all_gather", "psum_scatter",
           "all_to_all", "all_to_all_start", "ppermute", "all_reduce", "pmax",
           "rank_block", "gather_replicated", "replicated"]
