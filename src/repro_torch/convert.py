"""Turn the JAX reference's parameters into the port's state.

The reference's params are ``repro.models.model.Model.init(...)`` mapped
to numpy (``jax.tree.map(np.asarray, params)``): ``params["layers"][j]``
holds pattern slot j with every leaf stacked over periods on axis 0 (an
encoder-decoder's ``encoder`` stacked over its layers, with ``enc_norm``
and each decoder layer's ``norm_cross`` / ``cross``; a VLM's
``frontend_proj``).  The port's state keeps that tree, so the conversion
is leaf for leaf; only
the device changes, and each leaf takes the dtype the reference's
``Model.init`` gives it: the config's, except the leaves it keeps in fp32
(the MoE router; Mamba's ``a_log`` and ``d_skip``; the mLSTM's ``w_if``;
the sLSTM's ``w_gates`` and ``r_gates``: :data:`FP32_LEAVES`), as the
port's ``Model.init`` does.  Given a rank and a group size, each leaf is
cut to that rank's block while it is still a numpy array, by the rule of
:func:`repro_torch.parallel.sharding.shard_params` (the model's
``rank_specs``), so a rank never holds the whole model on its device.
This module imports neither JAX nor the reference: it takes numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import _DTYPES, build_model
from repro_torch.models import mamba, moe, xlstm
from repro_torch.parallel.sharding import shard_params

# Every leaf the reference keeps in fp32 whatever the model's dtype.
FP32_LEAVES = moe.FP32_LEAVES | mamba.FP32_LEAVES | xlstm.FP32_LEAVES


def _convert(tree, dtype, device):
    if isinstance(tree, dict):
        return {
            k: _convert(v, torch.float32 if k in FP32_LEAVES else dtype,
                        device)
            for k, v in tree.items()
        }
    if isinstance(tree, (list, tuple)):
        return [_convert(v, dtype, device) for v in tree]
    arr = np.array(tree, dtype=np.float32)  # a writable copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def params_from_jax(tree_of_numpy, cfg: ModelConfig, *, device=None,
                    rank: int | None = None, size: int = 1) -> dict:
    """The port's state for ``cfg`` from the reference's numpy params;
    with ``rank``, that rank's blocks for a group of ``size`` processes
    (:meth:`Model.rank_specs <repro_torch.models.model.Model.rank_specs>`;
    a family without a per-rank form raises)."""
    dev = resolve_device(device)
    model = build_model(cfg)  # raises for a family the port lacks
    if rank is not None:
        tree_of_numpy = shard_params(
            tree_of_numpy, model.rank_specs(size), rank, size)
    state = _convert(tree_of_numpy, _DTYPES[cfg.dtype], dev)
    if len(state["layers"]) != len(model.pattern):
        raise ValueError(
            f"{len(state['layers'])} pattern slots in the params, "
            f"{len(model.pattern)} in {cfg.name}"
        )
    return state


def opt_state_from_jax(numpy_opt_state, cfg: ModelConfig, *,
                       device=None) -> dict:
    """The port's optimizer state from the reference's, mapped to numpy.

    ``m`` and ``v`` keep the params' tree in fp32, the moments'
    ``init_state`` dtype in both packages' train loops; ``step`` becomes a
    0-dim int32 tensor on the device.
    """
    dev = resolve_device(device)
    build_model(cfg)  # raises for a family the port lacks
    return {
        "m": _convert(numpy_opt_state["m"], torch.float32, dev),
        "v": _convert(numpy_opt_state["v"], torch.float32, dev),
        "step": torch.tensor(int(np.asarray(numpy_opt_state["step"])),
                             dtype=torch.int32, device=dev),
    }


__all__ = ["params_from_jax", "opt_state_from_jax"]
