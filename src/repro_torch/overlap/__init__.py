"""The FiCCO overlap schedules and their public entry point.

  * schedules — the six executable schedules over stacked ranks
  * api       — ``ficco_linear`` and ``resolve_schedule``
"""
