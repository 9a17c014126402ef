"""The mutable index (counterpart of `repro/index`).

  delta       — `DeltaState` / `build_correction`: item inserts and
                tombstones, user upserts and deletions, absorbed without
                a rebuild and folded into every query as an exact
                additive correction, with stale-sample accounting;
  snapshot    — `IndexSnapshot` / `SnapshotManager`: immutable
                epoch-versioned generations behind one reference, so a
                swap never tears a query;
  maintenance — `MaintenancePolicy` / `MaintenanceLoop`: a background
                rebuild when the delta ratio, the stale-sample budget or
                the measured correction cost is exceeded, hot-swapped
                without pausing serving; `RebuildRecord`, what a rebuild
                reports;
  persist     — `IndexPersister`: atomic checksummed snapshot spills per
                rebuild epoch and an append-only mutation WAL;
                `ReverseKRanksEngine.restore` recovers the durable
                state, `PersistError` means rebuild from the master copy.

The mutation API lives on `ReverseKRanksEngine` (insert_items,
delete_items, upsert_users, delete_users, rebuild).
"""
from repro_torch.index.delta import (BaseIndex, DeltaState, DeltaStats,
                                     build_correction, residual_after_rebuild)
from repro_torch.index.maintenance import (MaintenanceLoop,
                                           MaintenancePolicy, RebuildRecord)
from repro_torch.index.persist import (IndexPersister, PersistError,
                                       WalRecord, load_latest)
from repro_torch.index.snapshot import IndexSnapshot, SnapshotManager, \
    compose_remaps

__all__ = ["BaseIndex", "DeltaState", "DeltaStats", "build_correction",
           "residual_after_rebuild", "IndexSnapshot", "SnapshotManager",
           "MaintenanceLoop", "MaintenancePolicy", "RebuildRecord",
           "IndexPersister", "PersistError", "WalRecord", "load_latest",
           "compose_remaps"]
