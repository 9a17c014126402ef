"""Delta buffer: index mutations absorbed without a rebuild.

Counterpart of `repro/index/delta.py`. Algorithm 1 freezes an item set
P₀ and a user set U₀ into the rank table; the delta buffer holds the
difference between that base and the live sets, and every query folds
it in as an exact additive correction:

  * inserted items are scored against every user, once per mutation, and
    counted per (user, query) at query time
    (`DeltaCorrection.add_scores`);
  * deleted base items are tombstoned: their scores are subtracted the
    same way, and the sampled positions they held are tracked
    (`DeltaStats.stale_weight`), since those samples keep contributing
    Eq. (1) mass for items that no longer exist;
  * upserted users have just their table rows re-estimated against the
    retained sample (`rank_table.recompute_user_rows`), and deleted
    users are a live mask that puts their rows past every selection.

Host-side ids and masks are numpy, as in the reference; item vectors and
score sets are tensors on the engine's device. Every state is immutable
and updated functionally, so a query against an older snapshot never
sees a later mutation.

The sampling state comes from the build's positions and weights (the
reference re-derives it from its JAX key, which the port cannot do).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rank_table as rt_mod
from repro_torch.core.types import DeltaCorrection, RankTableConfig, \
    StorageSpec


def _rows(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """x[idx] for host row indices."""
    return x[torch.from_numpy(np.asarray(idx, np.int64)).to(x.device)]


@dataclasses.dataclass(frozen=True)
class BaseIndex:
    """The frozen substrate a rank table was built over, kept so that the
    index can be mutated and rebuilt.

    items:        (m_base, d) base item vectors, insertion order.
    item_ids:     (m_base,) ascending stable ids (they survive rebuilds).
    samples:      (ω·s, d) the build's stratified sample vectors.
    weights:      (ω·s,) stratum weights |P_l| / s on the device.
    weights_host: their host copy, for the statistics.
    sample_ids:   (ω·s,) the item id at each sampled position: the join
                  key of deletions against the sample.
    max_norm:     () f32 max ‖p‖ (threshold_mode="norm_bound").
    positions:    (ω·s,) the sampled positions into the norm order.
    order:        (m_base,) the norm-descending permutation of `items`.
    """

    items: torch.Tensor
    item_ids: np.ndarray
    samples: torch.Tensor
    weights: torch.Tensor
    weights_host: np.ndarray
    sample_ids: np.ndarray
    max_norm: torch.Tensor
    positions: torch.Tensor
    order: torch.Tensor

    @classmethod
    def create(cls, items: torch.Tensor, item_ids: np.ndarray,
               cfg: RankTableConfig, positions: torch.Tensor,
               weights: torch.Tensor) -> "BaseIndex":
        """The sampling state of a build over `items` with these
        positions and weights (`rank_table.sampling_artifacts`)."""
        art = rt_mod.sampling_artifacts(items, cfg, positions=positions,
                                        weights=weights)
        ids = np.asarray(item_ids, np.int64)
        order = art.order.cpu().numpy()
        return cls(items=items, item_ids=ids, samples=art.samples,
                   weights=art.weights,
                   weights_host=art.weights.cpu().numpy(),
                   sample_ids=ids[order[art.positions.cpu().numpy()]],
                   max_norm=art.max_norm, positions=art.positions,
                   order=art.order)

    @property
    def m_base(self) -> int:
        return int(self.item_ids.size)

    def positions_of(self, ids: np.ndarray) -> np.ndarray:
        """Base positions of `ids` (item_ids is ascending); -1 if absent."""
        ids = np.asarray(ids, np.int64)
        pos = np.searchsorted(self.item_ids, ids)
        pos = np.clip(pos, 0, self.item_ids.size - 1)
        return np.where(self.item_ids[pos] == ids, pos, -1)


@dataclasses.dataclass(frozen=True)
class DeltaStats:
    """Delta-buffer accounting for the rebuild policy."""

    n_added: int            # live inserted items
    n_deleted: int          # tombstoned base items
    n_dead_users: int
    n_touched_users: int    # rows re-estimated in place since the base
    m_base: int
    m_live: int             # m_base − n_deleted + n_added
    delta_ratio: float      # (n_added + n_deleted) / m_base
    stale_weight: float     # Σ stratum weights of tombstoned samples
    stale_fraction: float   # stale_weight / m_base

    def __str__(self):
        return (f"+{self.n_added}/-{self.n_deleted} items "
                f"({self.delta_ratio:.3f} of m={self.m_base}), "
                f"{self.n_dead_users} dead users, "
                f"stale {self.stale_fraction:.4f}")


@dataclasses.dataclass(frozen=True)
class DeltaState:
    """Immutable mutation set relative to one `BaseIndex`.

    base_live:     (m_base,) bool; False marks tombstoned base items.
    added_ids:     (A,) int64 ids of live inserted items (an item
                   inserted and then deleted leaves the buffer).
    added_items:   (A, d) their vectors, or None when A == 0.
    user_live:     (n,) bool; False marks deleted users.
    touched_users: user rows re-estimated since the base (the rebuild
                   re-bases them).
    """

    base_live: np.ndarray
    added_ids: np.ndarray
    added_items: Optional[torch.Tensor]
    user_live: np.ndarray
    touched_users: frozenset

    @classmethod
    def empty(cls, m_base: int, n_users: int) -> "DeltaState":
        return cls(base_live=np.ones(m_base, bool),
                   added_ids=np.empty(0, np.int64), added_items=None,
                   user_live=np.ones(n_users, bool),
                   touched_users=frozenset())

    @property
    def n_added(self) -> int:
        return int(self.added_ids.size)

    @property
    def n_deleted(self) -> int:
        return int((~self.base_live).sum())

    @property
    def is_empty(self) -> bool:
        return (self.n_added == 0 and self.n_deleted == 0
                and bool(self.user_live.all()))

    def stats(self, base: Optional[BaseIndex]) -> DeltaStats:
        m_base = base.m_base if base is not None else int(self.base_live.size)
        stale = 0.0
        if base is not None and self.n_deleted:
            dead_ids = base.item_ids[~self.base_live]
            stale = float(base.weights_host[
                np.isin(base.sample_ids, dead_ids)].sum())
        return DeltaStats(
            n_added=self.n_added, n_deleted=self.n_deleted,
            n_dead_users=int((~self.user_live).sum()),
            n_touched_users=len(self.touched_users),
            m_base=m_base, m_live=m_base - self.n_deleted + self.n_added,
            delta_ratio=(self.n_added + self.n_deleted) / max(m_base, 1),
            stale_weight=stale, stale_fraction=stale / max(m_base, 1))

    def with_inserted(self, ids: np.ndarray, vectors: torch.Tensor
                      ) -> "DeltaState":
        added = (vectors if self.added_items is None
                 else torch.cat([self.added_items, vectors]))
        return dataclasses.replace(
            self, added_ids=np.concatenate([self.added_ids,
                                            np.asarray(ids, np.int64)]),
            added_items=added)

    def with_deleted(self, ids: np.ndarray, base: Optional[BaseIndex]
                     ) -> "DeltaState":
        """Tombstone base items and drop inserted items, by id; KeyError
        for an unknown or already deleted id."""
        ids = np.unique(np.asarray(ids, np.int64))
        in_added = np.isin(ids, self.added_ids)
        base_live = self.base_live.copy()
        if base is not None:
            pos = base.positions_of(ids[~in_added])
        else:
            pos = np.full((~in_added).sum(), -1)
        unknown = ids[~in_added][pos < 0]
        if unknown.size:
            raise KeyError(f"unknown item ids {unknown.tolist()}")
        dead_already = ~base_live[pos]
        if dead_already.any():
            raise KeyError(f"item ids already deleted: "
                           f"{ids[~in_added][dead_already].tolist()}")
        base_live[pos] = False
        keep = ~np.isin(self.added_ids, ids)
        added_items = self.added_items
        if added_items is not None and not keep.all():
            added_items = (_rows(added_items, np.flatnonzero(keep))
                           if keep.any() else None)
        return dataclasses.replace(self, base_live=base_live,
                                   added_ids=self.added_ids[keep],
                                   added_items=added_items)

    def with_users(self, *, touched: Tuple[int, ...] = (),
                   dead: Tuple[int, ...] = (), n_users: Optional[int] = None
                   ) -> "DeltaState":
        """Record upserted rows and user deletions; `n_users` grows the
        live mask after an append. An upsert revives no deleted row."""
        user_live = self.user_live
        if n_users is not None and n_users > user_live.size:
            user_live = np.concatenate(
                [user_live, np.ones(n_users - user_live.size, bool)])
        else:
            user_live = user_live.copy()
        user_live[list(dead)] = False
        return dataclasses.replace(
            self, user_live=user_live,
            touched_users=self.touched_users | frozenset(touched))


def _bucket(width: int) -> int:
    """A delta width rounded up to a power of two (at least 8), so that
    score-set shapes repeat under streaming mutations. The left padding
    is the absent sentinel, which no count includes."""
    if width == 0:
        return 0
    b = 8
    while b < width:
        b *= 2
    return b


def _sorted_padded(scores: torch.Tensor, width: int) -> torch.Tensor:
    """f32 rows sorted and padded to their bucket (hand-built
    corrections in tests)."""
    out, _, _ = StorageSpec().pack_scores(
        torch.sort(scores.to(torch.float32), dim=1).values,
        _bucket(width) - width)
    return out


def _packed_scores(users: torch.Tensor, items: torch.Tensor, width: int,
                   spec: StorageSpec):
    """Score `items` against every user (an f32 product, TF32 off, like
    step 1's), sort each row, pack it in spec space and left-pad it to
    its bucket → (rows, scale, offset)."""
    raw = torch.sort((users @ items.T).to(torch.float32), dim=1).values
    return spec.pack_scores(raw, _bucket(width) - width)


def build_correction(users: torch.Tensor, base: Optional[BaseIndex],
                     delta: DeltaState, m_base: int,
                     spec: Optional[StorageSpec] = None
                     ) -> Optional[DeltaCorrection]:
    """The query-time `DeltaCorrection` of one snapshot, None when the
    delta is empty (the static path). O(n·|delta|·d) once per mutation:
    the f32 users (the system of record) are scored against the delta
    items, and each row is sorted and packed in the storage spec."""
    if delta.is_empty:
        return None
    spec = StorageSpec() if spec is None else spec
    n = users.shape[0]
    empty = torch.zeros((n, 0), dtype=torch.float32, device=users.device)
    add, add_sc, add_off = empty, None, None
    dele, del_sc, del_off = empty, None, None
    if delta.n_added:
        add, add_sc, add_off = _packed_scores(users, delta.added_items,
                                              delta.n_added, spec)
    if delta.n_deleted:
        dead = _rows(base.items, np.flatnonzero(~delta.base_live))
        dele, del_sc, del_off = _packed_scores(users, dead,
                                               delta.n_deleted, spec)
    return DeltaCorrection(
        add_scores=add, del_scores=dele,
        user_live=torch.from_numpy(delta.user_live).to(users.device),
        m_new=m_base - delta.n_deleted + delta.n_added,
        add_scale=add_sc, add_off=add_off, del_scale=del_sc, del_off=del_off)


def residual_after_rebuild(old_base: BaseIndex, delta_now: DeltaState,
                           new_ids: np.ndarray) -> DeltaState:
    """Re-base `delta_now` onto a rebuild over the items `new_ids` that
    were live when it was captured: an id of `new_ids` no longer live is
    a residual tombstone, a live inserted id not in `new_ids` a residual
    insert. `touched_users` resets (the swap re-estimates those rows)."""
    live_now = np.concatenate(
        [old_base.item_ids[delta_now.base_live], delta_now.added_ids])
    base_live = np.isin(np.asarray(new_ids, np.int64), live_now)
    keep = ~np.isin(delta_now.added_ids, new_ids)
    added_items = None
    if delta_now.added_items is not None and keep.any():
        added_items = _rows(delta_now.added_items, np.flatnonzero(keep))
    return DeltaState(base_live=base_live,
                      added_ids=delta_now.added_ids[keep],
                      added_items=added_items,
                      user_live=delta_now.user_live.copy(),
                      touched_users=frozenset())
