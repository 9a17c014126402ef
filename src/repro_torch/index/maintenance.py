"""Rebuild records (counterpart of part of `repro/index/maintenance.py`).

`RebuildRecord` is what `ReverseKRanksEngine.rebuild` returns. The
reference's rebuild policy (`MaintenancePolicy`) and its background loop
(`MaintenanceLoop`) belong with durability and are not ported here.
"""
from __future__ import annotations

import dataclasses

from repro_torch.index.delta import DeltaStats


@dataclasses.dataclass(frozen=True)
class RebuildRecord:
    """One completed rebuild and swap, as the engine observed it."""

    epoch_before: int       # snapshot the rebuild was captured from
    epoch_after: int        # epoch published by the swap
    reason: str
    build_s: float          # Algorithm 1 wall time, off the mutation lock
    swap_s: float           # re-base and publish wall time, under it
    stats: DeltaStats       # delta accounting at capture time
    users_compacted: int = 0        # deleted rows the swap dropped
    users_reordered: bool = False   # the swap published a cluster reorder
