"""Analytic roofline counters: the work a step must do.

Port of the reference's ``repro.roofline`` counters
(:mod:`repro_torch.roofline.counters`) and parameter counts
(:mod:`repro_torch.roofline.analysis`).  ``chip_smoke.py`` divides their
FLOPs and bytes by the card's peaks for the bounds it prints beside its
measured times.
"""

from repro_torch.roofline.analysis import (
    active_params,
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
    "active_params", "model_flops_for",
]
