"""Analytic roofline counters: the work a step must do.

Port of the reference's ``repro.roofline``: the counters
(:mod:`repro_torch.roofline.counters`), and the parameter counts and the
three-term :class:`Roofline` (:mod:`repro_torch.roofline.analysis`).
``chip_smoke.py`` divides their FLOPs and bytes by the card's peaks for
the bounds it prints beside its measured times.
"""

from repro_torch.roofline.analysis import (
    CollectiveStats,
    Roofline,
    active_params,
    analyze,
    count_params,
    model_flops_for,
)
from repro_torch.roofline.counters import (
    Costs,
    forward_costs,
    param_bytes,
    step_costs,
)

__all__ = [
    "Costs", "forward_costs", "param_bytes", "step_costs", "count_params",
    "active_params", "model_flops_for", "CollectiveStats", "Roofline",
    "analyze",
]
