"""Synthetic scenario batches at sweep scale (1e6-1e7 lanes; port of
``repro.sweep.synth``).

``workload.scenario_grid`` enumerates the registry architectures (~720
scenarios); the sweep subsystem wants millions.  These constructors
build :class:`~repro_torch.core.batch.ScenarioBatch` / ``RaggedBatch``
struct-of-arrays *directly* — four int64 arrays (plus one float matrix
for ragged) — so a 1e7-lane batch costs ~300 MB of array memory and no
Python-object churn.

Everything is seeded and vectorized: the same ``(n, seed)`` reproduces
the same batch on every host, which is what lets multi-host sweeps
regenerate their owned shard locally instead of broadcasting operands.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.core.batch import RaggedBatch, ScenarioBatch
from repro_torch.core.workload import GemmShape, StepProfile

# M is drawn in multiples of this, so every group size up to 32
# decomposes evenly (matching workload.scenario_grid's convention); the
# engines mask indivisible combinations anyway.
_M_QUANTUM = 1024


def synthetic_batch(
    n: int,
    *,
    seed: int = 0,
    dtype_bytes: tuple[int, ...] = (2, 1),
) -> ScenarioBatch:
    """n log-uniform GEMM scenarios, deterministic in ``seed``.

    Shapes span the paper's regime: M in [1k, 2M] token rows (multiples
    of 1024), N/K in [1k, 64k] model dims (multiples of 128).
    """
    rng = np.random.default_rng(seed)
    m = _M_QUANTUM * np.exp(
        rng.uniform(np.log(1), np.log(2048), n)
    ).astype(np.int64)
    n_dim = 128 * np.exp(rng.uniform(np.log(8), np.log(512), n)).astype(
        np.int64
    )
    k_dim = 128 * np.exp(rng.uniform(np.log(8), np.log(512), n)).astype(
        np.int64
    )
    b = rng.choice(np.asarray(dtype_bytes, dtype=np.int64), size=n)
    return ScenarioBatch(m=m, n=n_dim, k=k_dim, dtype_bytes=b)


def synthetic_ragged_batch(
    n: int,
    *,
    steps: int = 8,
    seed: int = 0,
    dtype_bytes: tuple[int, ...] = (2, 1),
    concentration: float = 0.7,
) -> RaggedBatch:
    """n ragged scenarios with Dirichlet step profiles (skewed EP-like).

    ``concentration < 1`` produces hot-expert skew; rows renormalize to
    sum to 1 exactly, and a random tail of steps is zeroed on ~25% of
    rows to model masked/empty dispatch steps (mixed profile lengths).
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    sb = synthetic_batch(n, seed=seed, dtype_bytes=dtype_bytes)
    rng = np.random.default_rng(seed + 1)
    frac = rng.dirichlet(np.full(steps, concentration), size=n)
    if steps > 1:
        # Mask a tail on a quarter of the rows: profiles shorter than
        # ``steps`` (a 1-step profile is already the degenerate [1.0]).
        short = rng.random(n) < 0.25
        tail = rng.integers(1, steps, size=n)
        cols = np.arange(steps)[None, :]
        frac = np.where(
            short[:, None] & (cols >= tail[:, None]), 0.0, frac
        )
    frac /= frac.sum(axis=1, keepdims=True)
    return RaggedBatch(
        m=sb.m, n=sb.n, k=sb.k, dtype_bytes=sb.dtype_bytes, frac=frac
    )


# ---------------------------------------------------------------------------
# Drifting-skew serving traffic (the adaptive serving tier, serve/adapt.py).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One schedule-selection request of the synthetic serving stream."""

    gemm: GemmShape
    profile: StepProfile
    phase: int
    index: int


def drifting_request_stream(
    n: int,
    *,
    steps: int = 8,
    seed: int = 0,
    drift_every: int = 2000,
    n_shapes: int = 6,
    n_profiles: int = 8,
    concentration: float = 0.5,
    hot_boost: float = 8.0,
    quantum: int = 64,
) -> Iterator[ServeRequest]:
    """Seeded drifting-skew request stream for the adaptive serving tier.

    Serving traffic has a *small* working set at any moment — a few hot
    GEMM shapes and a family of expert-load profiles — that **drifts**:
    every ``drift_every`` requests the Dirichlet family's hot step
    rotates (phase ``p`` boosts step ``p % steps`` by ``hot_boost``)
    and the per-phase profile pool is redrawn, so cached decisions and
    the deployed gate go stale together.  Profiles are quantized to
    ``quantum``-ths (the same largest-remainder rounding the kernel
    layer applies), so digests repeat exactly within a phase — which is
    what makes a bounded decision cache effective between drift steps.

    Deterministic in ``seed``: the same ``(n, seed, ...)`` always
    yields the same stream, so benchmark runs are comparable.
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if drift_every < 1:
        raise ValueError(f"drift_every must be >= 1, got {drift_every}")
    sb = synthetic_batch(n_shapes, seed=seed)
    shapes = [
        GemmShape(int(sb.m[i]), int(sb.n[i]), int(sb.k[i]),
                  int(sb.dtype_bytes[i]))
        for i in range(n_shapes)
    ]
    phase = -1
    pool: list[StepProfile] = []
    pick_rng = np.random.default_rng(seed + 2)
    for i in range(n):
        p = i // drift_every
        if p != phase:
            phase = p
            # Per-phase profile family: hot step rotates with the phase.
            alpha = np.full(steps, concentration)
            alpha[phase % steps] *= hot_boost
            prng = np.random.default_rng((seed, phase))
            pool = []
            for j in range(n_profiles):
                frac = prng.dirichlet(alpha)
                raw = StepProfile.from_weights(
                    frac, name=f"drift{phase}.{j}"
                )
                counts = raw.quantize(quantum)
                if sum(counts) != quantum or not any(counts):
                    counts = (quantum,) + (0,) * (steps - 1)
                pool.append(
                    StepProfile(
                        tuple(c / quantum for c in counts),
                        name=f"drift{phase}.{j}",
                    )
                )
        yield ServeRequest(
            gemm=shapes[int(pick_rng.integers(n_shapes))],
            profile=pool[int(pick_rng.integers(len(pool)))],
            phase=phase,
            index=i,
        )


__all__ = [
    "synthetic_batch",
    "synthetic_ragged_batch",
    "ServeRequest",
    "drifting_request_stream",
]
