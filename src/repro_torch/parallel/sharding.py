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
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.device import resolve_device

_STATE = threading.local()
# Copy streams a group's chunk exchange spreads its copies over, at most one
# per rank: as many as an H100 has copy engines.  chip_smoke.py times the
# exchange on 1-4 streams (PERF.md): one stream per engine gave the
# steadiest device time, and more streams cost the host more to issue.
COPY_STREAMS = 3


class TPGroup:
    """``size`` logical tensor-parallel ranks held on one device.

    On CUDA the group owns the copy streams that the chunk exchange runs
    on, apart from the compute stream that runs the step GEMMs:
    ``COPY_STREAMS`` of them, at most one per rank.  The exchange is
    issued on the first and spread over the others, which are forked from
    it and joined back.
    """

    def __init__(self, size: int, device=None):
        if size < 1:
            raise ValueError(f"group size must be >= 1, got {size}")
        self.size = int(size)
        self.device = resolve_device(device)
        self._copy_streams = ()

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


__all__ = [
    "COPY_STREAMS",
    "TPGroup",
    "active_group",
    "tp_group",
    "shard_rows",
    "shard_columns",
]
