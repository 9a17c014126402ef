"""ReverseKRanksEngine — the port's public API.

Counterpart of `repro/core/engine.py`: Algorithm 1 (`build`) plus the
batched §4.3 query on a backend chosen by name ("dense", "fused", or
"pruned:<inner>"), at any storage spec. The f32 user matrix stays the
system of record; queries scan its spec-space storage
(`config.storage.pack_users`: None at f32, `StoredUsers` at bf16 and
int8). `build(..., cluster_reorder=True)` reorders the user rows by
k-means before the build, so that the pruned backend's blocks are tight,
and keeps the old→new row map as `user_remap`.

    eng = ReverseKRanksEngine.build(users, items, RankTableConfig(),
                                    1, backend="fused")
    res = eng.query_batch(qs, k=10, c=2.0)     # leading B axis on fields
    res = eng.query(q, k=10, c=2.0)            # the B = 1 case

Mutation (`repro_torch.index`). An engine from `build(...)` keeps its
item set and its sampling state, and mutates while it serves:

    ids = eng.insert_items(vectors)        # absorbed, no rebuild
    eng.delete_items(ids_to_drop)          # tombstoned, no rebuild
    eng.upsert_users(vectors, indices)     # rows re-estimated (K2)
    eng.upsert_users(vectors)              # append users
    eng.delete_users(indices)              # masked out of every result
    eng.delta_stats()                      # delta accounting
    eng.rebuild()                          # Algorithm 1 again + swap

Every mutation publishes a new immutable `IndexSnapshot`
(`repro_torch.index.snapshot`), and a query runs entirely against the
snapshot it took (`current_snapshot` / `query_batch_at`). Inserted and
deleted items shift every bound by exact counts (the delta correction);
a rebuild runs Algorithm 1 over the live items off the mutation lock and
swaps the new epoch in, re-basing what landed while it built.

Sampling state. The reference re-derives its samples from a JAX key; a
torch generator is consumed by its draw. So `build` keeps the positions
and weights it drew and the generator's state from before the draw, and
`rebuild` draws from a fresh generator set to that state: insert then
rebuild equals a build from scratch over the live items with the same
seed, bit for bit. An engine built from given `positions`/`weights`
rebuilds from given ones too (`rebuild(positions=, weights=)`).

Serving. `dispatch_batch_at(snap, qs, k, c)` is the serving twin of
`query_batch_at`: a host (numpy) block in, device tensors out, with no
host sync (`QueryBackend.dispatch_device`); `repro_torch.serve.
MicroBatcher` drives it. Both entries count `engine_queries_total` (and
`engine_delta_queries_total` on a mutated index, inside the
`engine.delta_correct` span) in `repro_torch.obs`, and `rebuild` carries
the chaos site `index.rebuild` (`repro_torch.serve.faults`).

Durability (`repro_torch.index.persist`). `attach_persister` spills the
current snapshot as a baseline and WAL-logs every later mutation; each
`rebuild` spills its new epoch inside the locked swap and rotates the
WAL; `ReverseKRanksEngine.restore(path)` loads the newest valid spill
and replays its WAL through the mutation API:

    eng.attach_persister(IndexPersister(path))
    ...                                    # mutations, rebuilds
    eng2 = ReverseKRanksEngine.restore(path, backend="fused")
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import pruning
from repro_torch.core import query as query_mod
from repro_torch.core import rank_table as rt_mod
from repro_torch.core.backends import QueryBackend, available_backends, \
    get_backend
from repro_torch.core.types import QueryResult, RankTable, RankTableConfig
from repro_torch.device import resolve_device
from repro_torch.index import delta as delta_mod
from repro_torch.index.maintenance import RebuildRecord
from repro_torch.obs import registry as obs
from repro_torch.obs import trace
from repro_torch.serve import faults
from repro_torch.index.snapshot import IndexSnapshot, SnapshotManager, \
    compose_remaps


def _cluster_layout(users: torch.Tensor,
                    init_rows: Optional[torch.Tensor] = None
                    ) -> tuple[Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """(perm, old→new remap) from `pruning.kmeans_layout`, or
    (None, None) when the matrix is too small or the layout is already
    the k-means order (an identity reorder publishes no remap)."""
    perm = pruning.kmeans_layout(users, init_rows=init_rows)
    if perm is None or torch.equal(
            perm, torch.arange(perm.numel(), device=perm.device)):
        return None, None
    remap = torch.empty_like(perm)
    remap[perm] = torch.arange(perm.numel(), device=perm.device)
    return perm, remap


def _host(x) -> Optional[np.ndarray]:
    """A row map as a host int64 array (None stays None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.int64)


def _sync(t: torch.Tensor) -> None:
    """Wait for the work that produces `t` (a no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class ReverseKRanksEngine:
    """Owns the index snapshots; queries run on `backend`.

    Built from a rank table over `users`. With `items` (the base item
    set) and the build's `positions` and `weights`, the engine can also
    mutate items and rebuild; `generator_state` ((device, state) of the
    generator before the build's draw) lets `rebuild` draw its samples
    as a build with the same seed would. `user_remap` (n,) int64, or
    None: the old→new row map that `users` already reflects
    (`build(..., cluster_reorder=True)`).
    """

    def __init__(self, users: torch.Tensor, rank_table: RankTable,
                 config: RankTableConfig,
                 backend: Union[str, QueryBackend] = "dense",
                 user_remap=None, *, items: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None,
                 generator_state=None):
        self.config = config
        self._backend = get_backend(backend)
        base = None
        if items is not None:
            if positions is None or weights is None:
                raise ValueError(
                    "items= requires positions= and weights= (the build's "
                    "samples); use ReverseKRanksEngine.build(...), which "
                    "wires them")
            base = delta_mod.BaseIndex.create(
                items, np.arange(items.shape[0]), config, positions, weights)
        m_base = base.m_base if base is not None else rank_table.m
        snap = IndexSnapshot(
            epoch=0, users=users, rank_table=rank_table, config=config,
            base=base,
            delta=delta_mod.DeltaState.empty(m_base, users.shape[0]),
            corr=None, user_remap=_host(user_remap),
            stored_users=config.storage.pack_users(users))
        self._snapshots = SnapshotManager(snap)
        self._lock = threading.RLock()          # serializes mutations
        self._rebuild_lock = threading.Lock()   # one rebuild in flight
        self._next_item_id = m_base
        self._corr_cost: dict = {}              # measured delta-cost cache
        self._generator_state = generator_state
        self._persister = None                  # attach_persister wires it

    @classmethod
    def build(cls, users: torch.Tensor, items: torch.Tensor,
              cfg: RankTableConfig,
              generator: Union[int, torch.Generator, None], *,
              backend: Union[str, QueryBackend] = "dense", device=None,
              positions: Optional[torch.Tensor] = None,
              weights: Optional[torch.Tensor] = None,
              cluster_reorder: bool = False,
              kmeans_init: Optional[torch.Tensor] = None
              ) -> "ReverseKRanksEngine":
        """Run Algorithm 1 on `device` (the CUDA card unless the caller
        passes device='cpu') and return a query-ready, mutable engine.

        `generator` is a seed or a torch.Generator on that device (None:
        the device's default generator); the samples may instead be
        given as `positions` and `weights`.

        `cluster_reorder`: k-means-cluster the users and permute their
        rows before the build (`pruning.kmeans_layout`, whose initial
        centers are the rows `kmeans_init` if given), keeping the old→new
        map as `user_remap`; n is unchanged.
        """
        dev = resolve_device(device)
        users = users.to(device=dev, dtype=torch.float32).contiguous()
        items = items.to(device=dev, dtype=torch.float32).contiguous()
        state = None
        if positions is None:
            if isinstance(generator, int):
                seed, generator = generator, torch.Generator(device=dev)
                generator.manual_seed(seed)
            elif generator is None:
                generator = (torch.default_generator if dev.type == "cpu"
                             else torch.cuda.default_generators[
                                 dev.index if dev.index is not None
                                 else torch.cuda.current_device()])
            state = (dev, generator.get_state())
            positions, weights = rt_mod.stratified_sample_indices(
                items.shape[0], cfg, generator, device=dev)
        elif weights is None:
            raise ValueError("positions= needs weights= as well")
        positions = positions.to(dev)
        weights = weights.to(dev)
        remap = None
        if cluster_reorder:
            perm, remap = _cluster_layout(users, kmeans_init)
            if perm is not None:
                users = users[perm].contiguous()
        bk = get_backend(backend)
        rt = bk.build_index(users, items, cfg, None, positions=positions,
                            weights=weights)
        return cls(users=users, rank_table=rt, config=cfg, backend=bk,
                   user_remap=remap, items=items, positions=positions,
                   weights=weights, generator_state=state)

    @classmethod
    def restore(cls, path, *, backend: Union[str, QueryBackend] = "dense",
                device=None) -> "ReverseKRanksEngine":
        """Recover an engine from a persistence directory on `device`
        (the CUDA card unless the caller passes device='cpu').

        Loads the newest checksum-valid spill (`repro_torch.index.
        persist`), rebuilds its snapshot (what is not stored re-derives
        deterministically from the base items, positions and weights),
        then replays the spill's WAL through the mutation API. On the
        device type that spilled, the recovered engine is bitwise the
        engine that was running at the durable point (epochs, rank-table
        bytes, bounds), and its later `rebuild()` draws what that
        engine's would. A spill from another device type is not promised
        to be bitwise: the correction and the packed users are recomputed
        by that device's products (cuBLAS on the card), and the
        generator's state is not carried across, so `rebuild` then needs
        positions= and weights=. Raises `PersistError` when no durable
        point can be trusted (rebuild from the master copy instead).

        Durability is not re-armed: call `attach_persister(
        IndexPersister(path))` on the result to spill a fresh baseline.
        """
        from repro_torch.index import persist as persist_mod
        state = persist_mod.load_latest(path, device=device)
        snap = state.snapshot
        eng = cls(snap.users, snap.rank_table, state.config,
                  backend=backend)
        # graft the durable lineage over the constructor's epoch-0 state
        eng._snapshots = SnapshotManager(snap)
        eng._next_item_id = state.next_item_id
        eng._generator_state = state.generator_state
        for rec in state.wal:
            persist_mod.replay_record(eng, rec)
        return eng

    def attach_persister(self, persister) -> None:
        """Arm crash safety: spill the current snapshot as the baseline
        durable point, then WAL-log every later mutation; each rebuild
        spills its new epoch and rotates the WAL. Needs the base item
        set (engines from `build(...)`)."""
        with self._lock:
            snap = self._require_base("attach_persister")
            persister.spill(snap, next_item_id=self._next_item_id,
                            generator_state=self._generator_state)
            self._persister = persister

    def _wal_append(self, op: str, **arrays) -> None:
        """Record one mutation (the caller holds the mutation lock, after
        its `_publish`: the publish is the op's effect, the WAL makes it
        durable). None-valued arrays are left out."""
        if self._persister is None:
            return
        self._persister.append(op, {k: v for k, v in arrays.items()
                                    if v is not None})

    @property
    def backend_name(self) -> str:
        return self._backend.name

    @staticmethod
    def backends() -> list[str]:
        return available_backends()

    # ------------------------------------------------------------ queries
    def current_snapshot(self) -> IndexSnapshot:
        """The live index generation, one reference read. A caller that
        needs several consistent reads keeps it and uses
        `query_batch_at`."""
        return self._snapshots.current()

    def query_batch_at(self, snap: IndexSnapshot, qs: torch.Tensor, k: int,
                       c: float) -> QueryResult:
        """`query_batch` against a pinned snapshot: bounds, correction
        and selection all see that epoch, whatever mutation or swap
        happens meanwhile."""
        if qs.ndim != 2:
            raise ValueError(
                f"query_batch expects (B, d) queries; got {tuple(qs.shape)}")
        qs = qs.to(device=snap.users.device, dtype=torch.float32)
        return self._count_and_run(
            snap, qs.shape[0], lambda **kw: self._backend.query_batch(
                snap.rank_table, snap.query_users(), qs.contiguous(), k=k,
                c=c, **kw))

    def dispatch_batch_at(self, snap: IndexSnapshot, qs, k: int,
                          c: float) -> QueryResult:
        """The serving twin of `query_batch_at`: a host (numpy or CPU
        tensor) block in, a QueryResult of device tensors out, staged by
        the backend's `dispatch_device` in one copy and returned with no
        host sync; the caller copies the result back. Values are bitwise
        those of `query_batch_at` on the same block."""
        if qs.ndim != 2:
            raise ValueError(f"dispatch_batch_at expects (B, d) queries; "
                             f"got {tuple(qs.shape)}")
        return self._count_and_run(
            snap, qs.shape[0], lambda **kw: self._backend.dispatch_device(
                snap.rank_table, snap.query_users(), qs, k=k, c=c, **kw))

    @staticmethod
    def _count_and_run(snap: IndexSnapshot, batch: int, run) -> QueryResult:
        """Count the queries, and on a mutated index run `run(delta=)`
        inside the `engine.delta_correct` span; the static path passes no
        delta keyword."""
        reg = obs.get_default()
        reg.counter("engine_queries_total",
                    "queries executed (batch-expanded)").inc(batch)
        if snap.corr is None:
            return run()
        reg.counter("engine_delta_queries_total",
                    "queries served through delta corrections").inc(batch)
        with trace.span("engine.delta_correct", batch=batch,
                        epoch=snap.epoch):
            return run(delta=snap.corr)

    def query_batch(self, qs: torch.Tensor, k: int, c: float) -> QueryResult:
        """Batched queries: qs is (B, d); every field gains a leading B
        axis. One table pass serves the whole batch."""
        return self.query_batch_at(self.current_snapshot(), qs, k, c)

    def query(self, q: torch.Tensor, k: int, c: float) -> QueryResult:
        """One query — the B = 1 case of `query_batch`."""
        if q.ndim != 1:
            raise ValueError(f"query expects a (d,) vector; got "
                             f"{tuple(q.shape)} (use query_batch for (B, d) "
                             "blocks)")
        return query_mod.squeeze_result(self.query_batch(q[None, :], k, c))

    # ---------------------------------------------------------- mutations
    def _require_base(self, op: str) -> IndexSnapshot:
        snap = self.current_snapshot()
        if snap.base is None:
            raise ValueError(
                f"{op} requires the engine's base item set; construct with "
                "ReverseKRanksEngine.build(...) (or pass items=, positions= "
                "and weights=)")
        return snap

    _KEEP_REMAP = object()      # _publish sentinel: carry snap.user_remap

    def _publish(self, snap: IndexSnapshot, *, users=None, rank_table=None,
                 delta=None, base=None, user_remap=_KEEP_REMAP
                 ) -> IndexSnapshot:
        """Install the next epoch (the caller holds the mutation lock).
        The spec-space users are re-packed only when the users changed;
        a mutation that only masks users reuses the score sets."""
        users = snap.users if users is None else users
        rank_table = snap.rank_table if rank_table is None else rank_table
        delta = snap.delta if delta is None else delta
        base = snap.base if base is None else base
        if user_remap is ReverseKRanksEngine._KEEP_REMAP:
            user_remap = snap.user_remap
        m_base = base.m_base if base is not None else rank_table.m
        spec = self.config.storage
        stored = (snap.stored_users if users is snap.users
                  else spec.pack_users(users))
        if (snap.corr is not None and users is snap.users
                and base is snap.base
                and delta.added_ids is snap.delta.added_ids
                and delta.base_live is snap.delta.base_live):
            corr = snap.corr._replace(user_live=torch.from_numpy(
                delta.user_live).to(users.device))
        else:
            corr = delta_mod.build_correction(users, base, delta, m_base,
                                              spec=spec)
        new = IndexSnapshot(
            epoch=snap.epoch + 1, users=users, rank_table=rank_table,
            config=snap.config, base=base, delta=delta, corr=corr,
            user_remap=user_remap, stored_users=stored)
        return self._snapshots.publish(new)

    def _vectors(self, vectors) -> torch.Tensor:
        snap = self.current_snapshot()
        vectors = torch.atleast_2d(torch.as_tensor(vectors)).to(
            device=snap.users.device, dtype=torch.float32).contiguous()
        if vectors.shape[1] != snap.users.shape[1]:
            raise ValueError(f"expected (*, {snap.users.shape[1]}) vectors; "
                             f"got {tuple(vectors.shape)}")
        return vectors

    def insert_items(self, vectors) -> np.ndarray:
        """Insert item vectors and return their stable ids. The delta
        buffer absorbs them: queries count them exactly, no rebuild."""
        vectors = self._vectors(vectors)
        with self._lock:
            snap = self._require_base("insert_items")
            ids = np.arange(self._next_item_id,
                            self._next_item_id + vectors.shape[0],
                            dtype=np.int64)
            self._next_item_id += vectors.shape[0]
            self._publish(snap, delta=snap.delta.with_inserted(ids, vectors))
            self._wal_append("insert_items", vectors=vectors, ids=ids)
        return ids

    def delete_items(self, ids: Sequence[int]) -> None:
        """Delete items by stable id: base items are tombstoned, inserted
        ones leave the buffer. KeyError for unknown or deleted ids."""
        ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                         else list(ids), np.int64)
        with self._lock:
            snap = self._require_base("delete_items")
            self._publish(snap,
                          delta=snap.delta.with_deleted(ids, snap.base))
            self._wal_append("delete_items", ids=ids)

    def upsert_users(self, vectors, indices: Optional[Sequence[int]] = None
                     ) -> np.ndarray:
        """Replace user rows (`indices` given) or append users (None);
        returns their indices. Only their threshold/table rows are
        re-estimated, against the retained sample (K2 on the card), as a
        build over the new user matrix would (`recompute_user_rows`), and
        packed in the storage spec."""
        vectors = self._vectors(vectors)
        with self._lock:
            snap = self._require_base("upsert_users")
            n0 = snap.users.shape[0]
            if indices is None:
                idx = np.arange(n0, n0 + vectors.shape[0])
                users_new = torch.cat([snap.users, vectors])
            else:
                idx = np.asarray(list(indices), np.int64)
                if idx.size != vectors.shape[0]:
                    raise ValueError(f"{idx.size} indices for "
                                     f"{vectors.shape[0]} vectors")
                if idx.size and (idx.min() < 0 or idx.max() >= n0):
                    raise IndexError(f"user indices out of range [0, {n0})")
                if np.unique(idx).size != idx.size:
                    raise ValueError("duplicate user indices in upsert")
                users_new = snap.users.index_copy(
                    0, torch.from_numpy(idx).to(vectors.device), vectors)
            packed = self.config.storage.pack_table(*self._user_rows(
                users_new, torch.from_numpy(idx).to(vectors.device),
                snap.base))
            rt = snap.rank_table
            if indices is None:
                rt_new = rt.append_rows(packed)
            else:
                rt_new = rt.set_rows(
                    torch.from_numpy(idx).to(vectors.device), packed)
            self._publish(
                snap, users=users_new, rank_table=rt_new,
                delta=snap.delta.with_users(
                    touched=tuple(int(i) for i in idx),
                    n_users=users_new.shape[0]))
            self._wal_append("upsert_users", vectors=vectors,
                             indices=None if indices is None else idx)
        return idx

    def delete_users(self, indices: Sequence[int]) -> None:
        """Mask users out of every later result (their rows stay until a
        compacting rebuild)."""
        idx = np.asarray(list(indices), np.int64)
        with self._lock:
            snap = self.current_snapshot()
            n = snap.users.shape[0]
            if idx.size and (idx.min() < 0 or idx.max() >= n):
                raise IndexError(f"user indices out of range [0, {n})")
            self._publish(snap, delta=snap.delta.with_users(
                dead=tuple(int(i) for i in idx)))
            self._wal_append("delete_users", indices=idx)

    def _user_rows(self, users: torch.Tensor, rows: torch.Tensor,
                   base: delta_mod.BaseIndex):
        """f32 (thresholds, table) of rows `rows` of `users`, re-estimated
        against `base`'s sample."""
        cfg = self.config
        return rt_mod.recompute_user_rows(
            users, base.samples, base.weights, cfg,
            items=base.items if cfg.threshold_mode == "exact" else None,
            max_norm=base.max_norm, rows=rows)

    # ------------------------------------------------- rebuild / lifecycle
    def delta_stats(self) -> delta_mod.DeltaStats:
        """Delta-buffer accounting of the current snapshot."""
        snap = self.current_snapshot()
        return snap.delta.stats(snap.base)

    def correction_overhead(self, *, batch: int = 8, k: int = 10,
                            c: float = 2.0, iters: int = 2) -> float:
        """Measured cost of the delta correction: the wall-time ratio of
        a corrected to a static query of a probe batch (the first
        `batch` users as queries) on this engine's backend, synchronized
        with the card. Cached per correction shape; 1.0 on an unmutated
        index."""
        snap = self.current_snapshot()
        if snap.corr is None:
            return 1.0
        key = (snap.corr.n_add, snap.corr.n_del, snap.users.shape[0],
               batch, k, float(c))
        hit = self._corr_cost.get(key)
        if hit is not None:
            return hit
        qs = snap.users[:min(batch, snap.users.shape[0])].contiguous()
        users = snap.query_users()

        def run(delta) -> None:
            r = self._backend.query_batch(snap.rank_table, users, qs, k=k,
                                          c=c, delta=delta)
            _sync(r.indices)

        times = {}
        for name, delta in (("static", None), ("delta", snap.corr)):
            run(delta)                                  # warm-up
            t0 = time.perf_counter()
            for _ in range(iters):
                run(delta)
            times[name] = (time.perf_counter() - t0) / iters
        ratio = times["delta"] / max(times["static"], 1e-9)
        self._corr_cost[key] = ratio
        return ratio

    def live_items(self) -> torch.Tensor:
        return self._require_base("live_items").live_items()

    def live_item_ids(self) -> np.ndarray:
        return self._require_base("live_item_ids").live_item_ids()

    def _draw(self, m: int):
        """Positions and weights over m items from a fresh generator set
        to the build's state: what a build with the same seed draws."""
        if self._generator_state is None:
            raise ValueError(
                "this engine was built from given positions/weights; pass "
                "rebuild(positions=, weights=) for the live item set")
        dev, state = self._generator_state
        g = torch.Generator(device=dev)
        g.set_state(state)
        return rt_mod.stratified_sample_indices(m, self.config, g,
                                                device=dev)

    def rebuild(self, reason: str = "manual",
                compact_dead_above: Optional[float] = None,
                reorder_clusters: bool = False, *,
                positions: Optional[torch.Tensor] = None,
                weights: Optional[torch.Tensor] = None
                ) -> Optional[RebuildRecord]:
        """Algorithm 1 over the live items on this engine's backend, then
        an atomic swap to the new epoch; None if a rebuild is in flight.

        The build runs off the mutation lock. The swap re-bases what
        landed meanwhile: residual inserts and deletes carry over, and
        user rows upserted or appended mid-build are re-estimated against
        the new sample. The samples are drawn as `build` drew them (see
        the module docstring), or given as `positions`/`weights`.

        `compact_dead_above`: when the deleted-user fraction exceeds it,
        dead rows are dropped from users and table, and the old→new map
        (−1 for dropped rows) composes onto `user_remap`; skipped when
        the backend cannot query the smaller n. `reorder_clusters`:
        afterwards, reorder rows by k-means (`pruning.kmeans_layout`) and
        compose that map too.

        With a persister attached, the new epoch is spilled inside the
        locked swap, right after it is published, so no mutation falls
        between the durable points; `swap_s` includes the spill. A spill
        that fails with OSError is logged and disarms the WAL, leaving
        durability at the previous spill and the records logged before
        the rebuild until a spill succeeds; the rebuild stands.
        """
        if not self._rebuild_lock.acquire(blocking=False):
            return None
        try:
            if faults.ACTIVE is not None:
                # chaos site: a failing Algorithm-1 build
                faults.fire("index.rebuild")
            with self._lock:
                snap = self._require_base("rebuild")
            stats = snap.delta.stats(snap.base)
            live_items = snap.live_items().contiguous()
            live_ids = snap.live_item_ids()
            t0 = time.monotonic()
            if positions is None:
                positions, weights = self._draw(live_items.shape[0])
            elif weights is None:
                raise ValueError("positions= needs weights= as well")
            rt_new = self._backend.build_index(
                snap.users, live_items, self.config, None,
                positions=positions, weights=weights)
            base_new = delta_mod.BaseIndex.create(
                live_items, live_ids, self.config, positions, weights)
            _sync(rt_new.table)
            build_s = time.monotonic() - t0
            t1 = time.monotonic()
            with self._lock:
                now = self.current_snapshot()
                swapped, n_dropped, reordered = self._swap(
                    snap, now, rt_new, base_new, live_ids,
                    compact_dead_above, reorder_clusters)
                if self._persister is not None:
                    try:
                        self._persister.spill(
                            swapped, next_item_id=self._next_item_id,
                            generator_state=self._generator_state)
                    except OSError:
                        logging.getLogger(__name__).exception(
                            "rebuild spill failed; the WAL is disarmed "
                            "and durability stays at the previous spill "
                            "until a spill succeeds")
            return RebuildRecord(
                epoch_before=snap.epoch, epoch_after=swapped.epoch,
                reason=reason, build_s=build_s,
                swap_s=time.monotonic() - t1, stats=stats,
                users_compacted=n_dropped, users_reordered=reordered)
        finally:
            self._rebuild_lock.release()

    def _swap(self, snap, now, rt_work, base_new, live_ids,
              compact_dead_above, reorder_clusters):
        """Re-base `now` (the snapshot at swap time) onto a table built
        from `snap` (the snapshot at capture time) and publish it."""
        users_now = now.users
        n_built, n_now = snap.users.shape[0], users_now.shape[0]
        # stale rows: touched users whose vector changed since capture
        # (compared by vector: a user upserted before the capture and
        # again mid-build is touched in both), and mid-build appends
        cand = sorted(now.delta.touched_users)
        existing = [i for i in cand if i < n_built]
        stale = [i for i in cand if i >= n_built]
        if existing:
            je = torch.tensor(existing, device=users_now.device)
            same = torch.all(users_now[je] == snap.users[je], dim=1)
            stale += [i for i, s in zip(existing, same.tolist()) if not s]
        touched = sorted(set(stale) | set(range(n_built, n_now)))
        spec = self.config.storage
        if n_now > n_built:     # placeholder rows, re-estimated below
            grow = (n_now - n_built, rt_work.tau)
            rt_work = rt_work.append_rows(spec.pack_table(
                torch.zeros(grow, device=users_now.device),
                torch.ones(grow, device=users_now.device)))
        if touched:
            j = torch.tensor(touched, device=users_now.device)
            rt_work = rt_work.set_rows(j, spec.pack_table(
                *self._user_rows(users_now, j, base_new)))
        delta_new = delta_mod.residual_after_rebuild(snap.base, now.delta,
                                                     live_ids)
        remap = None
        n_dropped = 0
        live = delta_new.user_live
        if (compact_dead_above is not None and live.size
                and 1.0 - float(live.mean()) > compact_dead_above):
            keep = np.flatnonzero(live)
            if keep.size:
                n_dropped = int(live.size - keep.size)
                remap = np.full(live.size, -1, np.int64)
                remap[keep] = np.arange(keep.size)
                j = torch.from_numpy(keep).to(users_now.device)
                users_now = users_now[j]
                rt_work = rt_work.take_rows(j)
                delta_new = dataclasses.replace(
                    delta_new, user_live=np.ones(keep.size, bool))
        reordered = False
        if reorder_clusters:
            perm, rmap = _cluster_layout(users_now)
            if perm is not None:
                reordered = True
                users_now = users_now[perm].contiguous()
                rt_work = rt_work.take_rows(perm)
                delta_new = dataclasses.replace(
                    delta_new,
                    user_live=delta_new.user_live[perm.cpu().numpy()])
                remap = compose_remaps(remap, _host(rmap))
        swapped = self._publish(
            now, users=users_now, rank_table=rt_work, delta=delta_new,
            base=base_new, user_remap=compose_remaps(now.user_remap, remap))
        return swapped, n_dropped, reordered

    # ------------------------------------------------------ introspection
    @property
    def epoch(self) -> int:
        return self.current_snapshot().epoch

    @property
    def users(self) -> torch.Tensor:
        """The current f32 user matrix (the system of record)."""
        return self.current_snapshot().users

    @property
    def rank_table(self) -> RankTable:
        return self.current_snapshot().rank_table

    @property
    def stored_users(self):
        """The current spec-space users (None at f32)."""
        return self.current_snapshot().stored_users

    @property
    def user_remap(self) -> Optional[torch.Tensor]:
        """The lineage's old→new user-row map on the users' device (−1 for
        rows a compaction dropped), or None for the identity."""
        snap = self.current_snapshot()
        if snap.user_remap is None:
            return None
        return torch.from_numpy(snap.user_remap).to(snap.users.device)

    @property
    def n(self) -> int:
        return self.current_snapshot().users.shape[0]

    @property
    def d(self) -> int:
        return self.current_snapshot().users.shape[1]

    def memory_bytes(self) -> int:
        """Query-path storage, counted as the reference counts it:
        thresholds + table + the int8 per-row parameters + the user
        storage that the backends scan (stored rows, scale and slack when
        quantized, the f32 matrix otherwise) + the delta correction (its
        score sets, live mask and int8 parameters) until a rebuild."""
        snap = self.current_snapshot()
        sz = lambda a: 0 if a is None else a.numel() * a.element_size()
        rt = snap.rank_table
        total = (sz(rt.thresholds) + sz(rt.table) + sz(rt.thr_scale)
                 + sz(rt.thr_off) + sz(rt.tab_scale) + sz(rt.tab_off)
                 + sz(rt.thr_dev))
        su = snap.stored_users
        if su is None:
            total += sz(snap.users)
        else:
            total += sz(su.rows) + sz(su.scale) + sz(su.row_slack)
        if snap.corr is not None:
            cr = snap.corr
            total += (sz(cr.add_scores) + sz(cr.del_scores)
                      + cr.user_live.numel() + sz(cr.add_scale)
                      + sz(cr.add_off) + sz(cr.del_scale) + sz(cr.del_off))
        return total
