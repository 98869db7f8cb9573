"""The analytic core the schedule path reads (trimmed copies of ``repro.core``).

  * schedule_types — the :class:`Schedule` enum of the executable schedules
  * machine        — :class:`MachineSpec`, the reference's machines and
                     :data:`H100_SXM`
  * workload       — :class:`GemmShape` and Table I
  * linkmodel      — the comm model the serial gate reads
  * heuristics     — the Fig. 12a decision tree with the serial gate
"""
