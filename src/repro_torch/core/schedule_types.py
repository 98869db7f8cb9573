"""The executable FiCCO schedules (copy of ``repro.core.schedule_types``).

Only the :class:`Schedule` enum is kept: it is what ``select_schedule``
returns and what ``ficco_linear`` dispatches on.  The reference's taxonomy
of all eight variants (communication shape x uniformity x granularity) and
their inefficiency signatures serve its analytic explorer, which the port
does not have yet.
"""

from __future__ import annotations

import enum


class Schedule(enum.Enum):
    """The executable schedules studied in the paper (+ baselines)."""

    SERIAL = "serial"
    SHARD_P2P = "shard_p2p"  # AsyncTP-style ring at shard granularity
    UNIFORM_FUSED_1D = "uniform-fused-1d"
    HETERO_FUSED_1D = "hetero-fused-1d"
    HETERO_UNFUSED_1D = "hetero-unfused-1d"
    UNIFORM_FUSED_2D = "uniform-fused-2d"

    @property
    def is_ficco(self) -> bool:
        return self not in (Schedule.SERIAL, Schedule.SHARD_P2P)


__all__ = ["Schedule"]
