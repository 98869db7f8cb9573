"""Runtime overlap context: which FiCCO mode the current forward uses.

Set by the serving/prefill entry points around a forward; read by the TP
layers so the same model code runs dense or FiCCO-overlapped without
plumbing a flag through every layer signature.
"""

from __future__ import annotations

import contextlib
import threading

from repro_torch.configs.base import OverlapConfig

_STATE = threading.local()


def get_overlap() -> OverlapConfig | None:
    return getattr(_STATE, "overlap", None)


@contextlib.contextmanager
def overlap_context(cfg: OverlapConfig | None):
    prev = get_overlap()
    _STATE.overlap = cfg
    try:
        yield
    finally:
        _STATE.overlap = prev
