"""Three-term roofline of a step, parameter counts and model FLOPs.

Port of ``repro.roofline.analysis``:

    compute term    = FLOPs / (chips x peak FLOP/s)
    memory term     = bytes / (chips x HBM rate)
    collective term = collective bytes / (chips x link rate)

The constants are the H100 SXM data sheet's, as
:data:`repro_torch.core.machine.H100_SXM` holds them: 989e12 bf16 FLOP/s,
3.35e12 B/s of HBM3 and 450e9 B/s of NVLink per direction.

The reference's :func:`analyze` reads a compiled XLA artifact: its cost
analysis (which its dry-run overwrites with the analytic
``counters.step_costs``), its memory analysis, and the collectives that
``parse_collectives`` finds in its HLO text.  The port has no compiled
artifact, so :func:`analyze` takes the port's own counts: the step's
:class:`~repro_torch.roofline.counters.Costs`, the
:class:`CollectiveStats` of
:func:`repro_torch.parallel.collectives.counting` around the step, and the
peak memory the caller read.  ``parse_collectives`` reads XLA's HLO text
and has no counterpart here.

:func:`count_params` counts the leaves of the port's ``Model.init`` on the
``"meta"`` device, which allocates and draws nothing: the reference counts
``jax.eval_shape`` of its own, the same tree, so the same count, and no
398e9 random numbers for Jamba.
"""

from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core.machine import H100_SXM
from repro_torch.models.model import build_model
from repro_torch.parallel.collectives import CollectiveStats
from repro_torch.tree import leaves

PEAK_FLOPS = H100_SXM.peak_flops
HBM_BW = H100_SXM.hbm_bw
LINK_BW = H100_SXM.link_bw


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collectives: dict[str, float]
    collective_counts: dict[str, int]
    model_flops: float  # 6*N*D (or 6*N_active*D for MoE)
    bytes_per_device: float  # peak memory over the step

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / FLOPs: how much counted compute is useful
        (catches remat / redundancy waste).  > 1 means the counter
        under-reports (e.g. decode where 6ND is not the right model)."""
        if self.hlo_flops <= 0:
            return float("nan")
        return self.model_flops / self.hlo_flops

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": self.collectives,
            "collective_counts": self.collective_counts,
            "model_flops": self.model_flops,
            "bytes_per_device": self.bytes_per_device,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    costs,
    collectives: CollectiveStats,
    model_flops: float,
    bytes_per_device: float = float("nan"),
) -> Roofline:
    """The roofline of one step from the port's counts.

    ``costs``: the step's FLOPs and bytes
    (:func:`repro_torch.roofline.counters.step_costs`); ``collectives``:
    what :func:`~repro_torch.parallel.collectives.counting` recorded over
    the step (its forward's collectives; a backward's are not counted);
    ``bytes_per_device``: on the card, ``torch.cuda.max_memory_allocated``
    after the step with the peak reset before it, elsewhere NaN, as the
    reference gives when its memory analysis fails.
    """
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=float(costs.flops),
        hlo_bytes=float(costs.bytes),
        collective_bytes=collectives.total_bytes,
        collectives=dict(collectives.bytes_by_kind),
        collective_counts=dict(collectives.count_by_kind),
        model_flops=model_flops,
        bytes_per_device=float(bytes_per_device),
    )


@functools.lru_cache(maxsize=None)
def meta_state(cfg) -> dict:
    """``cfg``'s model state on the ``"meta"`` device: every leaf's shape
    and dtype, nothing allocated.  Cached per config (the configs are
    frozen and hash by value, so a changed copy is a new entry): a
    full-width meta init of 80 layers takes a second or two.  Shared by
    every caller, so read it and never write to it."""
    return build_model(cfg).init(0, device="meta")


def count_params(cfg) -> float:
    """Total parameter count of ``cfg``'s model (every leaf, fp32 ones
    included), summed as floats in the reference's leaf order."""
    return sum(float(math.prod(t.shape)) for t in leaves(meta_state(cfg)))


def active_params(cfg) -> float:
    """Active (per-token) params: MoE counts only top-k + shared experts."""
    total = count_params(cfg)
    if not cfg.moe:
        return total
    # subtract the inactive routed experts' share
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    n_moe_layers = cfg.num_layers // cfg.moe.every_k_layers
    routed = 3.0 * d * f * e * n_moe_layers
    active_routed = 3.0 * d * f * k * n_moe_layers
    return total - routed + active_routed


def model_flops_for(cfg, shape_cfg, kind: str) -> float:
    """MODEL_FLOPS = 6*N_active*D for training; 2*N_active*D for inference
    forward; decode D = global_batch tokens (one step)."""
    n = active_params(cfg)
    if kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape_cfg.global_batch


__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "CollectiveStats", "Roofline",
           "analyze", "meta_state", "count_params", "active_params",
           "model_flops_for"]
