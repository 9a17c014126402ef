"""Epoch-versioned index snapshots, swapped atomically under serving.

Counterpart of `repro/index/snapshot.py`. A snapshot is one immutable,
consistent generation of the index: users, rank table, delta buffer and
its pre-built query correction. The manager holds the current one
behind a single reference; mutations and rebuilds publish a new
generation and never edit a published one:

  * readers (`engine.query_batch`) take the reference once and run the
    whole call against that snapshot; the tensors of an older generation
    stay alive and unchanged while a reader holds them (every mutation
    builds new tensors, `RankTable.set_rows` included);
  * writers serialize on the engine's mutation lock and publish strictly
    increasing epochs; publishing is one reference assignment.

`publish` carries the chaos site `index.publish` (`serve.faults`): a
hot-swap that dies between build and pointer install.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core.types import DeltaCorrection, RankTable, \
    RankTableConfig, StoredUsers
from repro_torch.serve import faults

if TYPE_CHECKING:       # annotations only: the engine imports this module
    from repro_torch.index.delta import BaseIndex, DeltaState


def compose_remaps(first: Optional[np.ndarray],
                   second: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Compose two old→new user-row maps: `first` maps lineage-original
    rows to intermediate ones, `second` intermediate to current. −1 (a
    row a compaction dropped) absorbs through any later map; None is the
    identity on either side."""
    if first is None:
        return second
    if second is None:
        return first
    out = np.full(first.shape[0], -1, np.int64)
    alive = first >= 0
    out[alive] = second[first[alive]]
    return out


@dataclasses.dataclass(frozen=True)
class IndexSnapshot:
    """One immutable index generation.

    `corr` is the pre-built correction of `delta` (None when the delta is
    empty: the static path); `base` is None for an engine constructed
    without its item set, which can serve and mask users but not mutate
    items. `user_remap` (numpy, or None for the identity) maps
    lineage-original user rows to this snapshot's rows (−1 for rows a
    compaction dropped); compactions and reorders compose onto it and
    other mutations carry it. `stored_users` is the spec-space image of
    `users` (None at f32), re-packed whenever `users` changes; `users`
    stays the f32 system of record.
    """

    epoch: int
    users: torch.Tensor
    rank_table: RankTable
    config: RankTableConfig
    base: Optional["BaseIndex"]
    delta: "DeltaState"
    corr: Optional[DeltaCorrection]
    user_remap: Optional[np.ndarray] = None
    stored_users: Optional[StoredUsers] = None

    def query_users(self):
        """What backends scan: the spec-space storage, or the f32 users."""
        return self.users if self.stored_users is None else self.stored_users

    def client_user_ids(self, indices) -> np.ndarray:
        """Current-row user indices (what a query on this snapshot
        returns) → lineage-original ids; the identity without a remap."""
        idx = np.asarray(indices.cpu() if isinstance(indices, torch.Tensor)
                         else indices)
        if self.user_remap is None:
            return idx
        inv = np.full(self.n, -1, np.int64)
        src = np.flatnonzero(self.user_remap >= 0)
        inv[self.user_remap[src]] = src
        return inv[idx]

    @property
    def n(self) -> int:
        return self.users.shape[0]

    @property
    def m_live(self) -> int:
        if self.corr is not None:
            return self.corr.m_new
        return self.rank_table.m

    def _base(self) -> "BaseIndex":
        if self.base is None:
            raise ValueError("engine was constructed without its item set; "
                             "build it with ReverseKRanksEngine.build(...) "
                             "to enable item-level operations")
        return self.base

    def live_item_ids(self) -> np.ndarray:
        """Stable ids of the live items, base then inserted."""
        base = self._base()
        return np.concatenate([base.item_ids[self.delta.base_live],
                               self.delta.added_ids])

    def live_items(self) -> torch.Tensor:
        """The live item vectors, ordered like `live_item_ids`: what a
        rebuild from scratch runs Algorithm 1 over."""
        base = self._base()
        keep = torch.from_numpy(np.flatnonzero(self.delta.base_live)).to(
            base.items.device)
        kept = base.items[keep]
        if self.delta.added_items is None:
            return kept
        return torch.cat([kept, self.delta.added_items])


class SnapshotManager:
    """Atomic holder of the current `IndexSnapshot`."""

    def __init__(self, initial: IndexSnapshot):
        self._current = initial
        self._lock = threading.Lock()

    def current(self) -> IndexSnapshot:
        """The live generation: one reference read; a caller keeps the
        returned object for its whole operation."""
        return self._current

    def publish(self, snap: IndexSnapshot) -> IndexSnapshot:
        """Install a new generation; epochs must strictly increase (a
        stale publish means two writers did not serialize)."""
        if faults.ACTIVE is not None:
            # chaos site: a hot-swap dying between build and pointer
            # install; the old generation must keep serving untorn
            faults.fire("index.publish")
        with self._lock:
            if snap.epoch <= self._current.epoch:
                raise RuntimeError(
                    f"stale publish: epoch {snap.epoch} <= current "
                    f"{self._current.epoch} (concurrent writers must "
                    "serialize on the engine mutation lock)")
            self._current = snap
        return snap
