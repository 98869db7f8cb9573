"""Expert-parallel (EP) overlap: chunked all-to-all token dispatch.

Port of ``repro.overlap.moe`` over a logical group: the reference runs
each function on every device of an EP axis inside ``shard_map``; here the
group's ranks are stacked on dim 0 of every operand, as the port's
schedules stack them (:mod:`repro_torch.parallel.collectives`).  Given
``group=`` a :class:`~repro_torch.parallel.group.RankGroup`, each function
is one rank's ``shard_map`` body instead, on the reference's per-device
shapes, its exchanges the group's all-to-all (NCCL with a card per rank).

The paper's EP scenarios (Table I g13-g16): tokens are exchanged all to
all before the expert FFN GEMMs run, a data-dependent comm->compute pair.
FiCCO cuts the capacity dim into chunks; each chunk is exchanged and its
expert GEMMs start at once, so expert compute overlaps the rest of the
dispatch, and a hot expert's extra tokens (paper Fig. 5) arrive across
chunks whose compute is already pipelined.

Layout (GShard-style, grouped): rank r holds x[r] of (E, C, D), its
tokens grouped by destination expert (E global experts, C per-expert
capacity from this rank).  The all-to-all swaps the expert dim for the
source-rank dim: rank r receives (g, E_local, C, D), the tokens of every
source for its E_local = E / g experts, reshaped source-major to
(E_local, g * C, D) expert batches.  On one card the all-to-all is a
device-memory copy, so a chunked run costs what cutting the expert GEMMs
costs; the overlap it buys needs a group over several cards (ROADMAP A9).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.collectives import all_to_all, all_to_all_start
from repro_torch.parallel.group import RankGroup


def _ffn(x: torch.Tensor, w_up: torch.Tensor,
         w_down: torch.Tensor) -> torch.Tensor:
    """The experts' FFN, batched: gelu (tanh), up and down only.

    x: (..., E_local, T, D); w_up: (..., E_local, D, F); w_down: (...,
    E_local, F, D): every rank's experts, stacked, or one rank's.
    """
    h = F.gelu(torch.matmul(x, w_up), approximate="tanh")
    return torch.matmul(h, w_down)


def _check(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
           group: RankGroup | None = None) -> int:
    """Check the shapes; returns the group size."""
    if group is None:
        g, e, _, d = x.shape
        lead = (g,)
    else:
        if not isinstance(group, RankGroup):
            raise TypeError(f"group= takes a RankGroup, not {group!r}; a "
                            "logical group's ranks are stacked on dim 0")
        g, (e, _, d), lead = group.size, x.shape, ()
    if e % g:
        raise ValueError(f"{e} experts do not divide over {g} ranks")
    f = w_up.shape[-1]
    if (tuple(w_up.shape) != (*lead, e // g, d, f)
            or tuple(w_down.shape) != (*lead, e // g, f, d)):
        want = "(g, E/g, D, F) and (g, E/g, F, D)" if lead else \
            "(E/g, D, F) and (E/g, F, D)"
        raise ValueError(
            f"expert weights {tuple(w_up.shape)} and {tuple(w_down.shape)} "
            f"for x {tuple(x.shape)}: want {want}")
    return g


def _dispatch(x: torch.Tensor, g: int) -> torch.Tensor:
    """Tokens (..., E, c, D) -> the (..., g, E_local, c, D) blocks a rank
    sends: block s for rank s's experts."""
    *lead, e, c, d = x.shape
    return x.reshape(*lead, g, e // g, c, d)


def _expert_ffn(recv: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """A rank's experts on what it received, (..., g, E_local, c, D) with
    block s from rank s, -> the (..., g, E_local, c, D) blocks it sends
    back: each expert's batch source-major, (E_local, g * c, D)."""
    *lead, g, e_local, c, d = recv.shape
    expert_in = recv.transpose(-4, -3).reshape(*lead, e_local, g * c, d)
    out = _ffn(expert_in, w_up, w_down)
    return out.view(*lead, e_local, g, c, d).transpose(-4, -3)


def _exchange_ffn(piece: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, group: RankGroup | None = None
                  ) -> torch.Tensor:
    """Dispatch all-to-all, expert FFN, combine all-to-all of one capacity
    slice, tokens back in source layout: piece (g, E, c, D) stacked, or
    with ``group`` this rank's (E, c, D)."""
    g = piece.shape[0] if group is None else group.size
    recv = all_to_all(_dispatch(piece, g), group=group)
    back = all_to_all(_expert_ffn(recv, w_up, w_down), group=group)
    return back.view(piece.shape)


def serial_a2a_ffn(x: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, *,
                   group: RankGroup | None = None) -> torch.Tensor:
    """Baseline: one dispatch all-to-all, the expert FFN, one combine
    all-to-all.

    x: (g, E, C, D), rank r's tokens grouped by destination expert at
    [r]; w_up: (g, E/g, D, F), w_down: (g, E/g, F, D), rank r's experts'
    weights.  Returns (g, E, C, D), every rank's tokens back in source
    layout.  With ``group`` (a :class:`RankGroup`) the reference's
    per-device shapes, this rank's blocks: x (E, C, D), w_up (E/g, D, F),
    w_down (E/g, F, D) -> (E, C, D), the exchanges ``all_to_all(group=)``.
    """
    _check(x, w_up, w_down, group)
    return _exchange_ffn(x, w_up, w_down, group)


def skewed_chunk_sizes(capacity: int, profile) -> tuple[int, ...]:
    """Integer per-chunk capacity slice sizes following an expert load
    profile (:class:`repro_torch.core.workload.StepProfile`).

    Deterministic largest-remainder quantization; zero-sized chunks
    (masked profile tail, experts that received nothing) are kept in the
    tuple so chunk indices line up with profile steps: the dispatch skips
    them.
    """
    sizes = profile.quantize(capacity)
    assert sum(sizes) == capacity
    return sizes


def plan_chunks(c: int, g: int, *, chunks=None, chunk_sizes=None,
                profile=None, variant=None):
    """The capacity cut of :func:`ficco_a2a_ffn`: (chunk sizes, issue
    order), or None where it falls back to :func:`serial_a2a_ffn`.  The
    logical and the per-rank forms share it."""
    if variant is None and chunks is None and chunk_sizes is None:
        from repro_torch.tune.registry import resolve_variant

        variant = resolve_variant("ficco_a2a_ffn", group=g, profile=profile)
    if chunk_sizes is None and profile is not None:
        chunk_sizes = skewed_chunk_sizes(c, profile)
    if chunk_sizes is None:
        from_variant = chunks is None and variant is not None
        if from_variant:
            chunks = int(variant.chunks)
        n_chunks = chunks or g
        if c % n_chunks:
            if from_variant and c % g == 0:
                n_chunks = g  # promoted cut doesn't divide; classic cut
            else:
                return None
        chunk_sizes = (c // n_chunks,) * n_chunks
    else:
        chunk_sizes = tuple(int(s) for s in chunk_sizes)
        if any(s < 0 for s in chunk_sizes) or sum(chunk_sizes) != c:
            raise ValueError(
                f"chunk_sizes {chunk_sizes} must be >= 0 and sum to "
                f"capacity {c}"
            )
    order = list(range(len(chunk_sizes)))
    if variant is not None and variant.dispatch_order == "reverse":
        order.reverse()
    return chunk_sizes, order


def ficco_a2a_ffn(
    x: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    chunks: int | None = None,
    chunk_sizes=None,
    profile=None,
    variant=None,
    group: RankGroup | None = None,
) -> torch.Tensor:
    """FiCCO: the capacity dim cut into chunks, each chunk's dispatch
    all-to-all followed at once by its expert GEMMs.  Shapes as
    :func:`serial_a2a_ffn`'s, ``group`` too.

    The default cut is uniform (``chunks`` slices of ``C / chunks``).  The
    skew-aware path follows a non-uniform expert load instead: pass
    ``chunk_sizes`` (ints >= 0 summing to the capacity ``C``) or a
    ``profile`` (:class:`repro_torch.core.workload.StepProfile`, quantized
    by :func:`skewed_chunk_sizes`); empty chunks are skipped.

    ``variant`` (a :class:`repro_torch.tune.KernelVariant`) supplies the
    uniform chunk count when ``chunks``/``chunk_sizes``/``profile`` do not
    pin one, and its dispatch order: ``"reverse"`` issues the chunks last
    to first, while the outputs are still reassembled in capacity order,
    so the result does not depend on the order.  With none of them given
    the variant resolves through :mod:`repro_torch.tune.registry`.  A
    uniform cut that does not divide ``C`` falls back to one chunk per
    rank when the count came from the variant and ``g`` divides ``C``,
    else to :func:`serial_a2a_ffn` (:func:`plan_chunks`).

    Per rank, the next chunk's dispatch is issued before this chunk's
    FFN and waited for just before its own (:func:`~repro_torch.
    parallel.collectives.all_to_all_start`), so on NCCL it runs while
    the FFN does, as XLA's async collectives let the reference's; the
    combines are waited for before the outputs are read.  No gradient.
    """
    g = _check(x, w_up, w_down, group)
    c = x.shape[-2]
    plan = plan_chunks(c, g, chunks=chunks, chunk_sizes=chunk_sizes,
                       profile=profile, variant=variant)
    if plan is None:
        return serial_a2a_ffn(x, w_up, w_down, group=group)
    sizes, order = plan
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    order = [i for i in order if sizes[i]]  # empty chunks are skipped
    outs: dict = {}
    if group is None:
        for idx in order:
            piece = x[:, :, offsets[idx]:offsets[idx] + sizes[idx]]
            outs[idx] = _exchange_ffn(piece, w_up, w_down)
        dim = 2
    else:
        def start(idx):
            piece = x[:, offsets[idx]:offsets[idx] + sizes[idx]]
            return all_to_all_start(_dispatch(piece, g), group=group)

        pending = start(order[0])
        combines = {}
        for i, idx in enumerate(order):
            recv, work = pending
            if i + 1 < len(order):  # issued before this chunk's FFN
                pending = start(order[i + 1])
            work.wait()
            combines[idx] = all_to_all_start(
                _expert_ffn(recv, w_up, w_down), group=group)
        for idx, (back, work) in combines.items():
            work.wait()
            outs[idx] = back.view(x.shape[0], sizes[idx], x.shape[-1])
        dim = 1
    pieces = [outs[idx] for idx in sorted(outs)]
    if len(pieces) == 1:
        return pieces[0]
    return torch.cat(pieces, dim=dim)


__all__ = ["serial_a2a_ffn", "ficco_a2a_ffn", "plan_chunks",
           "skewed_chunk_sizes"]
