"""The FiCCO overlap schedules and their public entry point.

  * schedules — the six executable schedules over stacked ranks
  * api       — ``ficco_linear`` and ``resolve_schedule``
  * moe       — the expert-parallel all-to-all dispatch, serial and FiCCO
"""

from repro_torch.overlap.moe import (
    ficco_a2a_ffn,
    serial_a2a_ffn,
    skewed_chunk_sizes,
)

__all__ = ["ficco_a2a_ffn", "serial_a2a_ffn", "skewed_chunk_sizes"]
