"""Promotion registry: per-(machine-family, kernel, scenario-class) winners.

Port of ``repro.tune.registry`` (a copy).

``search_kernel_variants`` promotes its winner here; the kernels consult
:func:`resolve_variant` when called without an explicit ``variant=``.
Winners are keyed by the machine *family* (the name prefix before the
first ``/``, the reference's ``learn.gate`` machine-gate convention)
and the scenario class (``"uniform"`` vs ``"skewed"`` step profiles),
and persisted as ``kernel_variant`` artifacts in the autotune cache so a
search survives process restarts.

Resolution order: exact family entry → wildcard (``*``, the most recent
promotion for the kernel) → persisted artifact → structural default.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING

from repro_torch.tune.variants import KERNELS, KernelVariant, default_variant

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.autotune.cache import AutotuneCache
    from repro_torch.core.machine import MachineSpec
    from repro_torch.core.workload import StepProfile

VARIANT_ARTIFACT_KIND = "kernel_variant"

SCENARIO_CLASSES = ("uniform", "skewed")

_LOCK = threading.Lock()
_PROMOTED: dict[tuple[str, str, str], KernelVariant] = {}


def variant_family(machine: "MachineSpec | str | None") -> str:
    """Machine-family key: the name prefix before the first ``/``."""
    if machine is None:
        return "*"
    name = machine if isinstance(machine, str) else machine.name
    return name.split("/", 1)[0]


def scenario_class(profile: "StepProfile | None" = None) -> str:
    return "uniform" if profile is None or profile.is_uniform else "skewed"


def artifact_name(family: str, kernel: str, scen: str) -> str:
    return f"{family}/{kernel}/{scen}"


def set_variant(
    kernel: str,
    variant: KernelVariant | None,
    *,
    family: str = "*",
    scen: str = "uniform",
) -> None:
    """Install (or with None, drop) an in-process winner without persisting."""
    key = (family, kernel, scen)
    with _LOCK:
        if variant is None:
            _PROMOTED.pop(key, None)
        else:
            _PROMOTED[key] = variant


def promote_variant(
    kernel: str,
    variant: KernelVariant,
    *,
    machine: "MachineSpec | str | None" = None,
    profile: "StepProfile | None" = None,
    cache: "AutotuneCache | None" = None,
    persist: bool = True,
) -> None:
    """Make ``variant`` the default the kernel resolves for this context.

    Registered under both the machine family and the ``*`` wildcard (so
    kernels invoked without machine knowledge still pick up the latest
    winner), and written to the autotune cache artifact segment when
    ``persist`` is set.
    """
    fam = variant_family(machine)
    scen = scenario_class(profile)
    with _LOCK:
        _PROMOTED[(fam, kernel, scen)] = variant
        _PROMOTED[("*", kernel, scen)] = variant
    if persist:
        if cache is None:
            from repro_torch.autotune.tuner import get_tuner

            cache = get_tuner().cache
        payload = variant.to_payload()
        cache.put_artifact(VARIANT_ARTIFACT_KIND, artifact_name(fam, kernel, scen), payload)
        if fam != "*":
            cache.put_artifact(
                VARIANT_ARTIFACT_KIND, artifact_name("*", kernel, scen), payload
            )


def resolve_variant(
    kernel: str,
    machine: "MachineSpec | None" = None,
    *,
    group: int | None = None,
    profile: "StepProfile | None" = None,
    cache: "AutotuneCache | None" = None,
) -> KernelVariant:
    """The variant a kernel should run with when none was passed."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; known: {KERNELS}")
    scen = scenario_class(profile)
    fams = [variant_family(machine)]
    if fams[0] != "*":
        fams.append("*")
    with _LOCK:
        for fam in fams:
            hit = _PROMOTED.get((fam, kernel, scen))
            if hit is not None:
                return hit
    # Persisted promotion from an earlier process.
    try:
        if cache is None:
            from repro_torch.autotune.tuner import get_tuner

            cache = get_tuner().cache
        for fam in fams:
            payload = cache.get_artifact(
                VARIANT_ARTIFACT_KIND, artifact_name(fam, kernel, scen)
            )
            if payload:
                variant = KernelVariant.from_payload(dict(payload))
                with _LOCK:
                    _PROMOTED[(fam, kernel, scen)] = variant
                return variant
    except Exception:  # pragma: no cover - cache unavailable is non-fatal
        pass
    return default_variant(kernel, machine, group=group)


def reset_variants() -> None:
    """Drop every in-process promotion (test isolation)."""
    with _LOCK:
        _PROMOTED.clear()
