"""Training substrate: the train step and the loop with logging/checkpoints.

Port of ``repro.train.loop``, in eager PyTorch.  The state is the
reference's tree, ``{"params": ..., "opt_state": {"m", "v", "step"}}``,
of tensors; :func:`make_train_step` returns a function of (state, batch)
that computes the loss under the model's overlap context, its gradients
by autograd, and one AdamW update.  The TP MLP's FiCCO overlap applies
only inside ``tp_group(TPGroup(g))``, as the reference's applies only
under a mesh; on ``uniform-fused-2d`` its up and gate projections run K2
forward and the plain products of K2's autograd Function backward.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build_model
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.parallel.context import overlap_context
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, unflatten


def loss_and_grads(model: Model, params, batch, *, accum_steps: int = 1):
    """(loss, {"ce", "aux"}, grads) of ``model.loss`` at ``params``.

    ``grads`` is a tree like ``params``: in each parameter's dtype for one
    microbatch, the fp32 mean over ``accum_steps`` microbatches (the
    batch split on its leading dim) otherwise, as the reference's
    ``lax.scan`` sums them.  A parameter the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives it.
    """
    flat = leaves(params)

    def one(mb):
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in flat]
            with overlap_context(model.config.overlap):
                loss, parts = model.loss(unflatten(params, live), mb)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    if accum_steps == 1:
        loss, parts, grads = one(batch)
        return loss, parts, unflatten(params, grads)
    micro = {
        k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:])
        for k, v in batch.items()
    }
    g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in flat]
    l_sum = ce_sum = aux_sum = 0.0
    for i in range(accum_steps):
        loss, parts, grads = one({k: v[i] for k, v in micro.items()})
        for acc, g in zip(g_sum, grads):
            acc.add_(g)
        l_sum = l_sum + loss
        ce_sum = ce_sum + parts["ce"]
        aux_sum = aux_sum + parts["aux"]
    k = 1.0 / accum_steps
    return (l_sum * k, {"ce": ce_sum * k, "aux": aux_sum * k},
            unflatten(params, [g * k for g in g_sum]))


def make_train_step(
    model: Model,
    ocfg: opt.OptimizerConfig,
    *,
    accum_steps: int = 1,
) -> Callable:
    """(state_tree, batch) -> (state_tree, metrics).

    ``accum_steps`` > 1 enables gradient-accumulation microbatching: the
    global batch is split on its leading dim and run one microbatch at a
    time, cutting live activation memory ~accum_steps-fold for one extra
    fp32 gradient buffer.  The metrics (loss, ce, aux, lr, grad_norm) are
    0-dim tensors on the state's device.
    """

    def train_step(state, batch):
        loss, parts, grads = loss_and_grads(
            model, state["params"], batch, accum_steps=accum_steps
        )
        params, opt_state, om = opt.apply_updates(
            state["params"], grads, state["opt_state"], ocfg
        )
        metrics = {
            "loss": loss, "ce": parts["ce"], "aux": parts["aux"], **om
        }
        return {"params": params, "opt_state": opt_state}, metrics

    return train_step


def init_train_state(model: Model, seed: int = 0, *, device=None) -> dict:
    params = model.init(seed, device=device)
    return {"params": params, "opt_state": opt.init_state(params)}


def train(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    steps: int = 50,
    seed: int = 0,
    ocfg: Optional[opt.OptimizerConfig] = None,
    log_every: int = 10,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    log_fn=print,
    device=None,
) -> dict:
    """Single-process training loop on ``device`` (default ``cuda``).

    Run it inside ``tp_group(TPGroup(g))`` for the model's overlap mode to
    apply to the TP MLPs.
    """
    dev = resolve_device(device)
    ocfg = ocfg or opt.OptimizerConfig(
        warmup_steps=max(steps // 20, 5), decay_steps=steps
    )
    model = build_model(cfg)
    state = init_train_state(model, seed, device=dev)
    step_fn = make_train_step(model, ocfg)
    data = make_pipeline(cfg, shape, seed=seed, device=dev)

    history = []
    reg = _metrics.get_metrics()
    t0 = time.time()
    for step, batch in zip(range(steps), data):
        with _trace.span("train/step", "train", step=step):
            state, metrics = step_fn(state, batch)
        reg.counter("train/steps").inc()
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall"] = time.time() - t0
            history.append(m)
            log_fn(
                f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f}"
            )
        if checkpoint_dir and checkpoint_every and (
            step % checkpoint_every == checkpoint_every - 1
        ):
            from repro_torch.ckpt.checkpoint import save_checkpoint

            save_checkpoint(checkpoint_dir, state, step)
    return {"state": state, "history": history, "model": model}


__all__ = [
    "loss_and_grads",
    "make_train_step",
    "init_train_state",
    "train",
]
