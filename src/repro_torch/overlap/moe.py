"""Expert-parallel (EP) overlap: chunked all-to-all token dispatch.

Port of ``repro.overlap.moe`` over a logical group: the reference runs
each function on every device of an EP axis inside ``shard_map``; here the
group's ranks are stacked on dim 0 of every operand, as the port's
schedules stack them (:mod:`repro_torch.parallel.collectives`).

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

from repro_torch.parallel.collectives import all_to_all


def _ffn(x: torch.Tensor, w_up: torch.Tensor,
         w_down: torch.Tensor) -> torch.Tensor:
    """Every rank's experts' FFN, batched: gelu (tanh), up and down only.

    x: (g, E_local, T, D); w_up: (g, E_local, D, F); w_down: (g, E_local,
    F, D).
    """
    h = F.gelu(torch.matmul(x, w_up), approximate="tanh")
    return torch.matmul(h, w_down)


def _exchange_ffn(piece: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    """Dispatch all-to-all, expert FFN, combine all-to-all of one capacity
    slice.  piece: (g, E, c, D) -> (g, E, c, D), tokens back in source
    layout."""
    g, e, c, d = piece.shape
    e_local = e // g
    # dispatch: split the expert dim over ranks, concat the source dim.
    recv = all_to_all(piece.reshape(g, g, e_local, c, d))
    # (g, src, e_local, c, d) -> (g, e_local, src * c, d), source-major.
    expert_in = recv.transpose(1, 2).reshape(g, e_local, g * c, d)
    expert_out = _ffn(expert_in, w_up, w_down)
    send = expert_out.view(g, e_local, g, c, d).transpose(1, 2)
    return all_to_all(send).view(g, e, c, d)


def _check(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor):
    g, e, _, d = x.shape
    if e % g:
        raise ValueError(f"{e} experts do not divide over {g} ranks")
    f = w_up.shape[-1]
    if (tuple(w_up.shape) != (g, e // g, d, f)
            or tuple(w_down.shape) != (g, e // g, f, d)):
        raise ValueError(
            f"expert weights {tuple(w_up.shape)} and {tuple(w_down.shape)} "
            f"for x {tuple(x.shape)}: want (g, E/g, D, F) and (g, E/g, F, D)"
        )


def serial_a2a_ffn(x: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """Baseline: one dispatch all-to-all, the expert FFN, one combine
    all-to-all.

    x: (g, E, C, D), rank r's tokens grouped by destination expert at
    [r]; w_up: (g, E/g, D, F), w_down: (g, E/g, F, D), rank r's experts'
    weights.  Returns (g, E, C, D), every rank's tokens back in source
    layout.
    """
    _check(x, w_up, w_down)
    return _exchange_ffn(x, w_up, w_down)


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


def ficco_a2a_ffn(
    x: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    chunks: int | None = None,
    chunk_sizes=None,
    profile=None,
    variant=None,
) -> torch.Tensor:
    """FiCCO: the capacity dim cut into chunks, each chunk's dispatch
    all-to-all followed at once by its expert GEMMs.  Shapes as
    :func:`serial_a2a_ffn`'s.

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
    else to :func:`serial_a2a_ffn`.
    """
    _check(x, w_up, w_down)
    g, e, c, d = x.shape
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
                return serial_a2a_ffn(x, w_up, w_down)
        chunk_sizes = (c // n_chunks,) * n_chunks
    else:
        chunk_sizes = tuple(int(s) for s in chunk_sizes)
        if any(s < 0 for s in chunk_sizes) or sum(chunk_sizes) != c:
            raise ValueError(
                f"chunk_sizes {chunk_sizes} must be >= 0 and sum to "
                f"capacity {c}"
            )
    offsets = [sum(chunk_sizes[:i]) for i in range(len(chunk_sizes))]
    order = list(range(len(chunk_sizes)))
    if variant is not None and variant.dispatch_order == "reverse":
        order.reverse()
    outs: list = [None] * len(chunk_sizes)
    for idx in order:
        c_c = chunk_sizes[idx]
        if c_c == 0:
            continue  # empty chunk (masked tail / unloaded expert slot)
        piece = x[:, :, offsets[idx]:offsets[idx] + c_c]
        outs[idx] = _exchange_ffn(piece, w_up, w_down)
    pieces = [o for o in outs if o is not None]
    if len(pieces) == 1:
        return pieces[0]
    return torch.cat(pieces, dim=2)


__all__ = ["serial_a2a_ffn", "ficco_a2a_ffn", "skewed_chunk_sizes"]
