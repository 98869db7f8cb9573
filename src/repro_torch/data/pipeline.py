"""Synthetic deterministic data pipeline with host-side prefetch.

Port of ``repro.data.pipeline``.  :class:`SyntheticLM` draws the
reference's batches (tokens and labels, and the stub frontends' patch
embeddings or encoder frames) with the same
``np.random.default_rng((seed, step))`` calls, so batch ``step`` is
bit-identical in both packages: training is
reproducible and restartable from a checkpoint without a data state.
:class:`Prefetcher` keeps ``depth`` batches on the device, moved by its
own thread (pinned host memory and ``non_blocking`` copies on a CUDA
device).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.specs import train_specs


class SyntheticLM:
    """Markov-ish synthetic token stream: learnable but non-trivial."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.specs = train_specs(cfg, shape)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.specs["tokens"].shape
        v = self.cfg.vocab_size
        # token[t+1] depends on token[t] -> a model can actually learn it.
        base = rng.integers(0, v, (b, 1))
        steps = rng.integers(1, 3, (b, s))  # 1-bit transitions: learnable fast
        toks = (base + np.cumsum(steps, axis=1)) % v
        out = {"tokens": toks.astype(np.int32)}
        out["labels"] = out["tokens"]
        # The stub frontends' extras, drawn after the tokens in the specs'
        # order, as the reference draws them.
        for name, sp in self.specs.items():
            if name not in ("tokens", "labels"):
                out[name] = rng.standard_normal(sp.shape).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(batch: dict[str, np.ndarray], device) -> dict:
    """One batch of numpy arrays as tensors on ``device``; on CUDA through
    pinned host memory with ``non_blocking`` copies."""
    dev = torch.device(device)
    out = {}
    for name, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[name] = t
    return out


class Prefetcher:
    """Host thread that keeps ``depth`` batches, each passed through
    ``put_fn`` (e.g. :func:`to_device`), ready."""

    def __init__(self, it, put_fn, depth: int = 2):
        self.it = iter(it)
        self.put = put_fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        for batch in self.it:
            self.q.put(self.put(batch))

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()


def make_pipeline(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    seed: int = 0,
    device=None,
    depth: int = 2,
):
    """Prefetching iterator of batches on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    src = SyntheticLM(cfg, shape, seed)
    return Prefetcher(src, put_fn=lambda b: to_device(b, dev), depth=depth)


__all__ = ["SyntheticLM", "Prefetcher", "to_device", "make_pipeline"]
