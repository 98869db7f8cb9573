"""Workload descriptors: the (M, N, K) GEMMs + collectives the paper studies
(port of ``repro.core.workload``).

Table I of the paper lists GEMMs from real deployments (Llama-2/3
tensor-sequence parallelism, DeepSeek/Mixtral expert parallelism).  Each
scenario is a data-dependent collective -> GEMM pair:

  * SP+TP:  all-gather of M-sharded activations, then GEMM with N-sharded
            weights (Figure 3 of the paper).
  * EP:     all-to-all token dispatch, then (grouped) expert GEMM.

Conventions (paper §IV-C1): the *global* GEMM is (M, N, K); the activation
input (M, K) starts row-sharded over the group; weights (K, N) are resident
(column-sharded over N, which does not interact with the overlap).  Static
quantities:

  OTB  (op-to-byte)   = flops / bytes_touched          (arithmetic intensity)
  MT   (memory traffic) = M*K + K*N + M*N  elements     (paper's definition)
"""

from __future__ import annotations

import dataclasses
import enum
import math


class CollectiveKind(enum.Enum):
    ALL_GATHER = "all_gather"
    ALL_TO_ALL = "all_to_all"


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """A global GEMM: out(M, N) = in(M, K) @ w(K, N)."""

    m: int
    n: int
    k: int
    dtype_bytes: int = 2  # bf16

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k

    @property
    def elems_mt(self) -> float:
        """Paper's memory-traffic metric MT, in elements."""
        return float(self.m * self.k + self.k * self.n + self.m * self.n)

    @property
    def bytes_mt(self) -> float:
        return self.elems_mt * self.dtype_bytes

    @property
    def otb(self) -> float:
        """Static op-to-byte ratio (paper §IV-C1)."""
        return self.flops / self.bytes_mt

    def shard(self, ways: int, axis: str) -> "GemmShape":
        """Decompose along 'm' (row), 'k' (inner) or 'n' (output col)."""
        if axis == "m":
            if self.m % ways:
                raise ValueError(f"M={self.m} not divisible by {ways}")
            return dataclasses.replace(self, m=self.m // ways)
        if axis == "k":
            if self.k % ways:
                raise ValueError(f"K={self.k} not divisible by {ways}")
            return dataclasses.replace(self, k=self.k // ways)
        if axis == "n":
            if self.n % ways:
                raise ValueError(f"N={self.n} not divisible by {ways}")
            return dataclasses.replace(self, n=self.n // ways)
        raise ValueError(f"axis must be 'm', 'n' or 'k', got {axis!r}")

    def device_gemm(self, group: int) -> "GemmShape":
        """The per-device GEMM in a TP group: weights are column (N) sharded
        across the group, so each device computes (M, N/g, K) after the
        all-gather of the (M, K) activation.  Table I lists global GEMMs."""
        if self.n % group == 0:
            return self.shard(group, "n")
        return self


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A data-dependent collective -> GEMM overlap scenario (Table I row)."""

    name: str
    parallelism: str  # "SP+TP" | "EP"
    model: str
    gemm: GemmShape
    collective: CollectiveKind = CollectiveKind.ALL_GATHER

    @property
    def comm_bytes_per_device(self) -> float:
        """Bytes each device must *receive* before the dependent GEMM.

        For AG of the (M, K) activation sharded M-ways over ``g`` devices the
        per-device ingress is (g-1)/g * M*K elements.  We report the full
        gathered buffer M*K (what lands in the operand); per-link math is in
        the simulator.
        """
        return float(self.gemm.m * self.gemm.k) * self.gemm.dtype_bytes


def _sc(name: str, par: str, model: str, m: int, n: int, k: int) -> Scenario:
    kind = (
        CollectiveKind.ALL_TO_ALL if par == "EP" else CollectiveKind.ALL_GATHER
    )
    return Scenario(name, par, model, GemmShape(m, n, k), kind)


# --------------------------------------------------------------------------
# Table I: GEMMs occurring in real world scenarios.
# --------------------------------------------------------------------------
TABLE_I: tuple[Scenario, ...] = (
    _sc("g1", "SP+TP", "llama-3-405b", 16384, 16384, 131072),
    _sc("g2", "SP+TP", "llama-3-405b", 131072, 16384, 16384),
    _sc("g3", "SP+TP", "llama-3-405b", 53248, 16384, 131072),
    _sc("g4", "SP+TP", "llama-3-405b", 131072, 53248, 16384),
    _sc("g5", "SP+TP", "llama-2-70b", 8192, 8192, 262144),
    _sc("g6", "SP+TP", "llama-2-70b", 262144, 8192, 8192),
    _sc("g7", "SP+TP", "llama-2-70b", 28672, 8192, 262144),
    _sc("g8", "SP+TP", "llama-2-70b", 262144, 28672, 8192),
    _sc("g9", "SP+TP", "llama-3-405b", 196608, 18432, 16384),
    _sc("g10", "SP+TP", "llama-3-405b", 196608, 106496, 16384),
    _sc("g11", "SP+TP", "llama-2-70b", 1048576, 10240, 8192),
    _sc("g12", "SP+TP", "llama-2-70b", 1048576, 57344, 8192),
    _sc("g13", "EP", "DeepSeek", 1607680, 57344, 8192),
    _sc("g14", "EP", "Mixtral", 147456, 28672, 4096),
    _sc("g15", "EP", "Mixtral", 327680, 28672, 4096),
    _sc("g16", "EP", "Mixtral", 229376, 28672, 4096),
)

SCENARIOS = {s.name: s for s in TABLE_I}


def synthetic_scenarios(count: int = 16, seed: int = 0) -> list[Scenario]:
    """Deterministic 'unseen' scenarios with diverse OTB / MT (paper §VI-D).

    Spans M/K both > and < 1, and several orders of magnitude of FLOPs, like
    the paper's sixteen synthetic evaluation points.
    """
    rng = _SplitMix(seed)
    out: list[Scenario] = []
    ms = [4096, 8192, 16384, 32768, 65536, 131072, 262144, 524288]
    ks = [2048, 4096, 8192, 16384, 32768, 65536, 131072]
    ns = [4096, 8192, 16384, 28672, 57344]
    while len(out) < count:
        m = ms[rng.next() % len(ms)]
        k = ks[rng.next() % len(ks)]
        n = ns[rng.next() % len(ns)]
        name = f"syn{len(out)}"
        out.append(_sc(name, "SP+TP", "synthetic", m, n, k))
    return out


# --------------------------------------------------------------------------
# Ragged step profiles: non-uniform per-step work (capacity-skewed EP
# dispatch, hetero-chunk FiCCO variants).
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepProfile:
    """Per-step work fractions of a non-uniform FiCCO decomposition.

    ``fractions[s]`` is the share of the decomposed dimension (capacity
    rows for 1D schedules, K columns for 2D) carried by step ``s``; the
    shares sum to 1.  Zero entries are legal and model masked tail steps
    (a padded profile) or experts that received no tokens — the engines
    charge them exactly zero time and they can never stall the pipeline.

    The uniform ``g``-step schedule the paper studies is
    ``StepProfile.uniform(g)``; everything else widens the design space
    beyond the paper (ROADMAP "Non-uniform step lists").
    """

    fractions: tuple[float, ...]
    name: str = "custom"

    def __post_init__(self):
        if not self.fractions:
            raise ValueError("profile needs at least one step")
        if any(f < 0.0 for f in self.fractions):
            raise ValueError(f"negative step fraction in {self.fractions}")
        total = sum(self.fractions)
        if not math.isclose(total, 1.0, rel_tol=1e-9, abs_tol=1e-12):
            raise ValueError(f"fractions must sum to 1, got {total!r}")

    @property
    def steps(self) -> int:
        return len(self.fractions)

    @property
    def active_steps(self) -> int:
        return sum(1 for f in self.fractions if f > 0.0)

    @property
    def imbalance(self) -> float:
        """max/mean share over *active* steps: 1.0 == uniform."""
        act = [f for f in self.fractions if f > 0.0]
        return max(act) * len(act)

    @property
    def is_uniform(self) -> bool:
        return all(
            math.isclose(f, 1.0 / self.steps, rel_tol=1e-12)
            for f in self.fractions
        )

    def padded(self, steps: int) -> "StepProfile":
        """Zero-extend to ``steps`` entries (for batching mixed lengths)."""
        if steps < self.steps:
            raise ValueError(f"cannot pad {self.steps} steps down to {steps}")
        return dataclasses.replace(
            self, fractions=self.fractions + (0.0,) * (steps - self.steps)
        )

    def trimmed(self) -> "StepProfile":
        """Drop trailing zero steps (inverse of :meth:`padded`)."""
        last = max(
            (s for s, f in enumerate(self.fractions) if f > 0.0), default=0
        )
        return dataclasses.replace(self, fractions=self.fractions[: last + 1])

    def quantize(self, total: int) -> tuple[int, ...]:
        """Integer per-step sizes summing to ``total`` (largest remainder).

        Deterministic Hamilton rounding: floor every share, then hand the
        remainder out by descending fractional part (ties to the lower
        step index).  This is what the kernel layer uses to turn a load
        profile into concrete chunk row counts.
        """
        raw = [f * total for f in self.fractions]
        base = [int(math.floor(r)) for r in raw]
        rem = total - sum(base)
        order = sorted(
            range(self.steps), key=lambda s: (-(raw[s] - base[s]), s)
        )
        for s in order[:rem]:
            base[s] += 1
        return tuple(base)

    def digest(self) -> str:
        """Short stable identity string (autotune cache keys).

        Computed on the trimmed profile: zero padding is proven not to
        change any engine figure, so a padded profile must share its
        cache key with its trimmed twin rather than fragment the store.

        Memoized per instance — the class is frozen, so the identity
        never changes, and the hot decision paths (autotune cache,
        serving tier, signature stream) key by it on every call.
        """
        cached = self.__dict__.get("_digest")
        if cached is not None:
            return cached
        p = self.trimmed()
        if p.is_uniform:
            d = f"u{p.steps}"
        else:
            import hashlib

            h = hashlib.sha256()
            for f in p.fractions:
                h.update(repr(round(f, 12)).encode())
            d = f"{p.name}-{p.steps}-{h.hexdigest()[:10]}"
        object.__setattr__(self, "_digest", d)
        return d

    # -- constructors ---------------------------------------------------

    @classmethod
    def from_weights(cls, weights, name: str = "custom") -> "StepProfile":
        weights = [float(w) for w in weights]
        total = sum(weights)
        if total <= 0.0:
            raise ValueError("weights must have positive sum")
        return cls(tuple(w / total for w in weights), name=name)

    @classmethod
    def uniform(cls, steps: int) -> "StepProfile":
        return cls((1.0 / steps,) * steps, name="uniform")

    @classmethod
    def skewed(cls, steps: int, skew: float) -> "StepProfile":
        """Geometric capacity skew: step ``s`` carries weight ``skew**s``.

        ``skew=1`` is uniform; ``skew=2`` means each step carries twice
        the previous one's tokens (a hot-expert tail ramp); ``skew<1``
        front-loads.  The skew-factor sweep of the ragged scenario grid
        walks this knob.
        """
        if skew <= 0.0:
            raise ValueError(f"skew must be > 0, got {skew}")
        return cls.from_weights(
            [skew**s for s in range(steps)], name=f"skew{skew:g}"
        )

    @classmethod
    def zipf(cls, steps: int, alpha: float = 1.0) -> "StepProfile":
        """Zipf expert-load profile: weight ``1/(s+1)**alpha`` (hot head)."""
        return cls.from_weights(
            [1.0 / (s + 1) ** alpha for s in range(steps)],
            name=f"zipf{alpha:g}",
        )

    @classmethod
    def top_k_hot(
        cls, steps: int, hot: int = 1, hot_share: float = 0.5
    ) -> "StepProfile":
        """``hot`` steps split ``hot_share`` of the tokens; the rest split
        the remainder (top-k routing with a few saturated experts)."""
        if not 0 < hot < steps:
            raise ValueError(f"need 0 < hot < steps, got hot={hot}")
        if not 0.0 < hot_share < 1.0:
            raise ValueError(f"hot_share must be in (0, 1), got {hot_share}")
        cold = steps - hot
        return cls.from_weights(
            [hot_share / hot] * hot + [(1.0 - hot_share) / cold] * cold,
            name=f"top{hot}h{hot_share:g}",
        )


@dataclasses.dataclass(frozen=True)
class RaggedScenario:
    """A collective -> GEMM scenario with a non-uniform step profile.

    The profile describes how the decomposed dimension is split across
    FiCCO steps (e.g. per-chunk token counts of a capacity-skewed EP
    dispatch).  SERIAL and SHARD_P2P are profile-independent: they move
    the same aggregate bytes whatever the skew.
    """

    name: str
    parallelism: str
    model: str
    gemm: GemmShape
    profile: StepProfile
    collective: CollectiveKind = CollectiveKind.ALL_TO_ALL

    @classmethod
    def from_scenario(
        cls, scenario: Scenario, profile: StepProfile, suffix: str = ""
    ) -> "RaggedScenario":
        return cls(
            name=scenario.name + (suffix or f"/{profile.name}"),
            parallelism=scenario.parallelism,
            model=scenario.model,
            gemm=scenario.gemm,
            profile=profile,
            collective=scenario.collective,
        )


def ragged_scenario_grid(
    *,
    steps: int = 8,
    skews: tuple[float, ...] = (1.0, 2.0, 4.0),
    zipf_alphas: tuple[float, ...] = (1.0,),
    top_k: tuple[tuple[int, float], ...] = ((2, 0.6),),
    scenarios=None,
) -> list[RaggedScenario]:
    """Capacity-skewed EP-dispatch scenario families.

    Crosses the EP rows of Table I (or any caller-supplied scenarios)
    with a skew-factor sweep plus Zipf and top-k-hot expert load
    profiles — the non-uniform step lists real MoE serving produces.
    Feed the result straight to ``explore_grid`` (both backends accept
    ragged scenarios) or ``repro_torch.core.batch.evaluate_ragged_grid``.
    """
    if scenarios is None:
        scenarios = [s for s in TABLE_I if s.parallelism == "EP"]
    profiles: list[StepProfile] = [
        StepProfile.skewed(steps, s) for s in skews
    ]
    profiles += [StepProfile.zipf(steps, a) for a in zipf_alphas]
    profiles += [StepProfile.top_k_hot(steps, h, share) for h, share in top_k]
    out: list[RaggedScenario] = []
    for sc in scenarios:
        for p in profiles:
            out.append(RaggedScenario.from_scenario(sc, p))
    return out


def tp_token_rows(global_batch: int, seq_len: int, dp: int = 16) -> int:
    """Per-replica token rows of one TP-SP block (M of its AG->GEMMs)."""
    b = global_batch // dp if global_batch >= dp else global_batch
    return b * seq_len


def tp_gemms(cfg, m: int, dtype_bytes: int = 2) -> dict:
    """The data-dependent TP-SP AG->GEMM pairs of one block (global dims).

    Single source of truth for what an architecture's overlap-relevant
    GEMMs are: MLP up-projection, fused QKV projection, and the MoE
    shared-expert projection when present.  Used by ``scenario_grid``,
    ``benchmarks/bench_arch_schedules`` and the hillclimb analytic
    prepass, so the three stay in agreement.
    """
    gemms: dict[str, GemmShape] = {}
    if cfg.d_ff:
        gemms["mlp_up"] = GemmShape(m, cfg.d_ff, cfg.d_model, dtype_bytes)
    h = cfg.num_heads * cfg.resolved_head_dim
    qkv = h + 2 * cfg.num_kv_heads * cfg.resolved_head_dim
    gemms["attn_qkv"] = GemmShape(m, qkv, cfg.d_model, dtype_bytes)
    if cfg.moe and cfg.moe.num_shared_experts:
        gemms["shared_expert"] = GemmShape(
            m,
            cfg.moe.d_ff_expert * cfg.moe.num_shared_experts,
            cfg.d_model,
            dtype_bytes,
        )
    return gemms


def scenario_grid(
    *,
    seqs: tuple[int, ...] = (1024, 2048, 4096, 8192, 16384, 32768, 65536),
    microbatches: tuple[int, ...] = (1, 3, 16),
    dtype_bytes: tuple[int, ...] = (2, 1),
) -> list[Scenario]:
    """Design-space scenario grid: every registry architecture's
    data-dependent AG->GEMMs crossed with token-row counts and dtypes
    (paper §VI-D scaled from 16 points to thousands).

    Each architecture contributes its TP-SP pairs (:func:`tp_gemms`); M
    is the per-replica token-row count ``seq x microbatch``, deduplicated
    across colliding (seq, microbatch) products so every grid point is
    distinct.  All M are multiples of 1024, so every group size up to 32
    decomposes them evenly (the batched engine masks indivisible
    combinations anyway).  Pair with :func:`machine_grid` for the
    machine axis; the full cross goes through ``explore_grid`` whole.  The
    non-uniform counterpart is :func:`ragged_scenario_grid`
    (capacity-skewed EP families), which ``explore_grid`` also accepts
    directly.
    """
    from repro_torch.configs import ARCHS, get_config  # local: keep layering thin

    ms = sorted({seq * mb for seq in seqs for mb in microbatches})
    out: list[Scenario] = []
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        kinds = sorted(tp_gemms(cfg, ms[0]))
        for kind in kinds:
            for m in ms:
                for b in dtype_bytes:
                    gemm = tp_gemms(cfg, m, dtype_bytes=b)[kind]
                    name = f"{arch}/{kind}/m{m}/b{b}"
                    out.append(Scenario(name, "SP+TP", arch, gemm))
    return out


def machine_grid(
    *,
    groups: tuple[int, ...] = (8, 16),
) -> list:
    """Machine axis of the design space: every machine of ``MACHINES``
    (the reference's two and :data:`~repro_torch.core.machine.H100_SXM`)
    crossed with overlap-group sizes and both studied topologies (full mesh
    vs torus ring), link counts adjusted to match."""
    from repro_torch.core.machine import MACHINES, Topology

    out = []
    for base in MACHINES.values():
        for g in groups:
            for topo in (Topology.FULL_MESH, Topology.TORUS_RING):
                a2a = g - 1 if topo is Topology.FULL_MESH else 2
                out.append(
                    dataclasses.replace(
                        base,
                        name=f"{base.name}/g{g}/{topo.value}",
                        group=g,
                        topology=topo,
                        a2a_links=a2a,
                    )
                )
    return out


class _SplitMix:
    """Tiny deterministic PRNG so synthetic scenarios never drift."""

    def __init__(self, seed: int):
        self.state = (seed * 0x9E3779B97F4A7C15 + 1) & 0xFFFFFFFFFFFFFFFF

    def next(self) -> int:
        self.state = (self.state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = self.state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return (z ^ (z >> 31)) & 0x7FFFFFFF


def geomean(xs) -> float:
    xs = list(xs)
    if not xs:
        return float("nan")
    return math.exp(sum(math.log(x) for x in xs) / len(xs))
