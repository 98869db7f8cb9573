"""AdamW + cosine schedule over the port's state trees (no ``torch.optim``).

Port of ``repro.train.optimizer``.  Parameters, gradients and moments are
the nested dicts of tensors that the model state uses
(:mod:`repro_torch.tree`); the update runs in fp32 and casts each
parameter back to its own dtype, with the reference's bias-correction
order.  ``step`` is a 0-dim int32 tensor on the parameters' device, and
``lr`` and ``grad_norm`` stay 0-dim device tensors, so a step never waits
on the host.  :func:`state_specs` shards the moments like the parameters
(the dry-run's optimizer state, :mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.parallel.sharding import P
from repro_torch.tree import leaves, tree_map, unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # bf16 moments for >100B models keep the optimizer state small.
    moment_dtype: str = "float32"


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine to ``min_lr``; fp32."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * t)
    )
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params, moment_dtype: str = "float32") -> dict[str, Any]:
    dt = _DTYPES[moment_dtype]
    device = leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def state_specs(param_specs) -> dict[str, Any]:
    """The optimizer state's partition specs: ``m`` and ``v`` as the
    parameters', ``step`` replicated."""
    return {"m": param_specs, "v": param_specs, "step": P()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, leaf by leaf
    in the reference's order."""
    total = 0
    for g in leaves(tree):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptimizerConfig):
    """One AdamW step with global-norm clipping.  Returns (params, state,
    metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(cfg.b2, stepf)
    mdt = _DTYPES[cfg.moment_dtype]

    def upd(p, g, m, v):
        g = g.float() * scale
        m = (cfg.b1 * m.float() + (1 - cfg.b1) * g).to(mdt)
        v = (cfg.b2 * v.float() + (1 - cfg.b2) * g * g).to(mdt)
        del g
        # p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), each step in
        # place on a temporary made here (never on a leaf: ``.float()`` of
        # an fp32 leaf is the leaf), so the largest leaf's update holds
        # four fp32 temporaries at a time, not seven; the values are the
        # same bit for bit.
        den = (v.float() / bc2).sqrt_().add_(cfg.eps)
        delta = (m.float() / bc1).div_(den)
        del den
        delta.add_(cfg.weight_decay * p.float())
        return (p.float() - delta.mul_(lr)).to(p.dtype), m, v

    new = [upd(*leaf) for leaf in zip(leaves(params), leaves(grads),
                                      leaves(state["m"]), leaves(state["v"]))]
    return (
        unflatten(params, [n[0] for n in new]),
        {"m": unflatten(params, [n[1] for n in new]),
         "v": unflatten(params, [n[2] for n in new]), "step": step},
        {"lr": lr, "grad_norm": gnorm},
    )


__all__ = [
    "OptimizerConfig",
    "lr_at",
    "init_state",
    "state_specs",
    "global_norm",
    "apply_updates",
]
