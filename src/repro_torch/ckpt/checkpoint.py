"""Checkpointing: flat-leaf npz + JSON meta, atomic, restartable.

Port of ``repro.ckpt.checkpoint``, in its on-disk layout: ``ckpt_%08d.npz``
holds the state's leaves as ``leaf_<i>`` in the reference's flatten order
(sorted dict keys, :mod:`repro_torch.tree`), ``ckpt_%08d.json`` the step,
the tree's structure as the reference prints it and the leaf count, and
``latest`` the newest step.  So a reference checkpoint restores into the
port, and a port checkpoint of fp32 leaves into the reference.

numpy has no bfloat16, so a bf16 leaf is stored as its raw 16-bit words
in 2-byte void records (``|V2``), the form in which a leaf that the
reference wrote with ``ml_dtypes``' bfloat16 reads back; the meta's
``dtypes`` list names every leaf's dtype, and restoring is bit-exact.
The reference's restore casts numerically, so it refuses such a leaf
(it has no cast from ``|V2``) rather than reading the words as integers.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves, treedef_str, unflatten

def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save_checkpoint(directory: str, state: Any, step: int) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = leaves(state)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    meta = {
        "step": step,
        "treedef": treedef_str(state),
        "n_leaves": len(flat),
        "dtypes": [str(t.dtype).removeprefix("torch.") for t in flat],
    }
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    np.savez(tmp, **{f"leaf_{i}": _to_numpy(t) for i, t in enumerate(flat)})
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    if os.path.exists(tmp):
        os.remove(tmp)
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(directory, "latest"), "w") as f:
        f.write(str(step))
    return path


def latest_step(directory: str) -> int | None:
    p = os.path.join(directory, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _stored_dtypes(directory: str, step: int) -> list | None:
    p = os.path.join(directory, f"ckpt_{step:08d}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f).get("dtypes")


def restore_checkpoint(directory: str, like: Any, step: int | None = None):
    """Restore into the structure of ``like`` (shapes validated); each leaf
    takes the dtype and device of ``like``'s.  Returns (state, step)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    dtypes = _stored_dtypes(directory, step)
    restored = []
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        for i, ref in enumerate(leaves(like)):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != "
                    f"{tuple(ref.shape)}"
                )
            raw16 = arr.dtype.kind == "V" and arr.dtype.itemsize == 2
            if raw16 or (dtypes is not None and dtypes[i] == "bfloat16"):
                t = torch.from_numpy(
                    np.ascontiguousarray(arr).view(np.int16)
                ).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            restored.append(t.to(device=ref.device, dtype=ref.dtype))
    return unflatten(like, restored), step


__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint"]
