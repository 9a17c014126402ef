"""ReverseKRanksEngine — the port's public API for a static index.

Counterpart of the static part of `repro/core/engine.py`: Algorithm 1
(`build`) plus the batched §4.3 query on a backend chosen by name
("dense", "fused", or "pruned:<inner>"), at any storage spec. The f32
user matrix stays the system of record; queries scan its spec-space
storage (`config.storage.pack_users`: None at f32, `StoredUsers` at
bf16 and int8). `build(..., cluster_reorder=True)` reorders the user
rows by k-means before the build, so that the pruned backend's blocks
are tight, and keeps the old→new row map as `user_remap`. Snapshots,
mutation and persistence are not ported yet (ROADMAP queue 1 item 7).

    eng = ReverseKRanksEngine.build(users, items, RankTableConfig(),
                                    1, backend="fused")
    res = eng.query_batch(qs, k=10, c=2.0)     # leading B axis on fields
    res = eng.query(q, k=10, c=2.0)            # the B = 1 case
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core import pruning
from repro_torch.core import query as query_mod
from repro_torch.core.backends import QueryBackend, available_backends, \
    get_backend
from repro_torch.core.types import QueryResult, RankTable, RankTableConfig
from repro_torch.device import resolve_device


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


class ReverseKRanksEngine:
    """Owns the user matrix and rank table; queries run on `backend`.

    `user_remap` (n,) int64, or None: the old→new row map that the user
    matrix already reflects (`build(..., cluster_reorder=True)`); row
    `user_remap[i]` holds the caller's user i.
    """

    def __init__(self, users: torch.Tensor, rank_table: RankTable,
                 config: RankTableConfig,
                 backend: Union[str, QueryBackend] = "dense",
                 user_remap: Optional[torch.Tensor] = None):
        self.users = users
        self.rank_table = rank_table
        self.config = config
        self.user_remap = user_remap
        self.stored_users = config.storage.pack_users(users)
        self._backend = get_backend(backend)

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
        passes device='cpu') and return a query-ready engine.

        `generator` is a seed or a torch.Generator on that device; the
        samples may instead be given as `positions` and `weights`.

        `cluster_reorder`: k-means-cluster the users and permute their
        rows before the build (`pruning.kmeans_layout`, whose initial
        centers are the rows `kmeans_init` if given), keeping the old→new
        map as `user_remap`; n is unchanged.
        """
        dev = resolve_device(device)
        users = users.to(device=dev, dtype=torch.float32).contiguous()
        items = items.to(device=dev, dtype=torch.float32).contiguous()
        if isinstance(generator, int):
            seed, generator = generator, torch.Generator(device=dev)
            generator.manual_seed(seed)
        remap = None
        if cluster_reorder:
            perm, remap = _cluster_layout(users, kmeans_init)
            if perm is not None:
                users = users[perm].contiguous()
        bk = get_backend(backend)
        rt = bk.build_index(users, items, cfg, generator,
                            positions=positions, weights=weights)
        return cls(users=users, rank_table=rt, config=cfg, backend=bk,
                   user_remap=remap)

    @property
    def backend_name(self) -> str:
        return self._backend.name

    @staticmethod
    def backends() -> list[str]:
        return available_backends()

    def query_batch(self, qs: torch.Tensor, k: int, c: float) -> QueryResult:
        """Batched queries: qs is (B, d); every field gains a leading B
        axis. One table pass serves the whole batch."""
        if qs.ndim != 2:
            raise ValueError(
                f"query_batch expects (B, d) queries; got {tuple(qs.shape)}")
        qs = qs.to(device=self.users.device, dtype=torch.float32)
        users = (self.users if self.stored_users is None
                 else self.stored_users)
        return self._backend.query_batch(self.rank_table, users,
                                         qs.contiguous(), k=k, c=c)

    def query(self, q: torch.Tensor, k: int, c: float) -> QueryResult:
        """One query — the B = 1 case of `query_batch`."""
        if q.ndim != 1:
            raise ValueError(f"query expects a (d,) vector; got "
                             f"{tuple(q.shape)} (use query_batch for (B, d) "
                             "blocks)")
        return query_mod.squeeze_result(self.query_batch(q[None, :], k, c))

    @property
    def n(self) -> int:
        return self.users.shape[0]

    @property
    def d(self) -> int:
        return self.users.shape[1]

    def memory_bytes(self) -> int:
        """Query-path storage, counted as the reference counts it:
        thresholds + table + the int8 per-row parameters + the user
        storage that the backends scan (stored rows, scale and slack when
        quantized, the f32 matrix otherwise)."""
        sz = lambda a: 0 if a is None else a.numel() * a.element_size()
        rt = self.rank_table
        total = (sz(rt.thresholds) + sz(rt.table) + sz(rt.thr_scale)
                 + sz(rt.thr_off) + sz(rt.tab_scale) + sz(rt.tab_off)
                 + sz(rt.thr_dev))
        su = self.stored_users
        if su is None:
            return total + sz(self.users)
        return total + sz(su.rows) + sz(su.scale) + sz(su.row_slack)
