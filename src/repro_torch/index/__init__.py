"""The mutable index (counterpart of `repro/index`).

  delta       — `DeltaState` / `build_correction`: item inserts and
                tombstones, user upserts and deletions, absorbed without
                a rebuild and folded into every query as an exact
                additive correction, with stale-sample accounting;
  snapshot    — `IndexSnapshot` / `SnapshotManager`: immutable
                epoch-versioned generations behind one reference, so a
                swap never tears a query;
  maintenance — `RebuildRecord`, what a rebuild reports.

The mutation API lives on `ReverseKRanksEngine` (insert_items,
delete_items, upsert_users, delete_users, rebuild).
"""
from repro_torch.index.delta import (BaseIndex, DeltaState, DeltaStats,
                                     build_correction, residual_after_rebuild)
from repro_torch.index.maintenance import RebuildRecord
from repro_torch.index.snapshot import IndexSnapshot, SnapshotManager, \
    compose_remaps

__all__ = ["BaseIndex", "DeltaState", "DeltaStats", "build_correction",
           "residual_after_rebuild", "IndexSnapshot", "SnapshotManager",
           "RebuildRecord", "compose_remaps"]
