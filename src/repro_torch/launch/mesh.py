"""Device meshes for the launch-time sharding specs.

Port of ``repro.launch.mesh``.  The reference builds ``jax.make_mesh``
over 256 or 512 placeholder devices; the spec rules
(:mod:`repro_torch.parallel.sharding`) read nothing of a mesh but its
ordered ``{axis name: size}``.  So :class:`Mesh` is that value and holds
no devices: a ``torch.distributed.DeviceMesh`` of 256 devices cannot be
built in one process without a process group, and the dry-run
(:mod:`repro_torch.launch.dryrun`) needs none.

Single pod: 256 devices as (data=16, model=16).  Multi-pod: 2 pods = 512
devices as (pod=2, data=16, model=16); ``pod`` is pure data parallelism,
``model`` the TP/EP (FiCCO) axis, ``data`` FSDP plus batch.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes, in order."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} and {self.axis_sizes} "
                             "differ in length")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}`` in axis order (``jax`` mesh ``.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        """The sizes joined by ``x``: ``16x16``, ``2x16x16``."""
        return "x".join(map(str, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model: int | None = None, *,
                   devices: int | None = None) -> Mesh:
    """(data, model) over ``devices`` devices, by default every visible
    CUDA card (none raises, as :func:`repro_torch.device.resolve_device`
    does); ``model`` defaults to all of them."""
    if devices is None:
        resolve_device("cuda")
        devices = torch.cuda.device_count()
    if model is None:
        model = devices
    if model < 1 or devices % model:
        raise ValueError(f"model={model} does not divide {devices} devices")
    return Mesh(("data", "model"), (devices // model, model))


__all__ = ["Mesh", "make_production_mesh", "make_host_mesh"]
