"""Pluggable query-execution backends.

Counterpart of `repro/core/backends.py`, with three registered backends:

  "dense"   — plain PyTorch step 1 (`core.query`): one (n, d)×(d, B)
              product plus one pass over the table per batch;
  "fused"   — step 1 in a kernel (`kernels.ops.bound_ranks_batched_stored`:
              K1 on an f32 table, K4 on bf16, K5 on int8) on CUDA
              tensors; its plain version on CPU tensors;
  "sharded" — row-sharded over a mesh of devices (`core.distributed`):
              local step 1 per shard, then the tree merge, which gathers
              (B, k·P) candidates; its results carry candidate-set
              bounds of shape (B, k·P), not (B, n).

`users` is the raw (n, d) matrix at f32 storage and `StoredUsers` at
bf16 and int8.

and three registered wrappers:

  "pruned:<inner>"  — block-pruned execution (`core.pruning`): phase A
            keeps the user tiles that can hold answers, phase B runs
            step 1 on them only ("pruned" alone is "pruned:dense");
  "elastic:<inner>" — one program per capacity bucket, never per n
            (`core.elastic`; "elastic:" is "elastic:dense");
  "cached:<inner>"  — within-tick dedupe and a per-query LRU
            (`serve.cache`).

The last two resolve by a lazy import of their module, so a spec works
without the caller importing it first.

`bound_ranks` takes a (B, d) block and returns (B, n) bounds; `select`
realizes §4.3 steps 2-3; `query_batch` composes the two. Wrapper specs
`"<prefix>:<inner>"` resolve through `register_wrapper`. Every backend
takes `mesh=` (a device list, `distributed.flat_mesh`), which only
"sharded" uses and wrappers pass inward; `check_users_shape(n)` raises
before a mutation grows the users to an n the backend cannot query. The serving
entry `dispatch_device` takes a host block, stages it on the device in
one copy and returns device tensors without a host sync; `degrade(level)`
is the degrade ladder's hook (`serve.degrade`).

On a mutated index `query_batch(..., delta=DeltaCorrection)` folds the
delta buffer in between step 1 and the selection, through the one
shared `rank_table.apply_delta_corrections`, so the backends cannot
drift apart: dense in `query.query_batch_delta`, fused (and any backend
with full (B, n) bounds) in `_delta_query`, sharded on each shard's rows
before its top-k, the pruned wrapper in phase B on the kept rows.
"""
from __future__ import annotations

import importlib
from collections import OrderedDict
from typing import Callable, Dict, Optional, Type

import numpy as np
import torch

from repro_torch.core import distributed
from repro_torch.core import pruning
from repro_torch.core import query as query_mod
from repro_torch.core import rank_table as rt_mod
from repro_torch.core.types import DeltaCorrection, QueryResult, \
    RankTable, RankTableConfig, StoredUsers, stored_rows, take_user_rows
from repro_torch.kernels import ops
from repro_torch.obs import trace


def host_block(qs, *, pinned: bool) -> torch.Tensor:
    """A host (numpy or CPU tensor) (B, d) query block as a contiguous
    f32 CPU tensor, in pinned memory if `pinned`, ready for one
    non-blocking copy to the card (PyTorch's pinned-memory cache keeps
    the buffer from reuse until that copy has run)."""
    if not isinstance(qs, torch.Tensor):
        qs = torch.from_numpy(np.ascontiguousarray(qs, dtype=np.float32))
    qs = qs.to(dtype=torch.float32).contiguous()
    if not pinned:
        return qs
    return torch.empty(qs.shape, dtype=torch.float32,
                       pin_memory=True).copy_(qs)


def stage_block(qs, device: torch.device) -> torch.Tensor:
    """A (B, d) query block as a contiguous f32 tensor on `device`; a
    host block reaches a CUDA device in ONE non-blocking copy from pinned
    memory (`host_block`), with no host sync."""
    if isinstance(qs, torch.Tensor) and qs.device == device:
        return qs.to(dtype=torch.float32).contiguous()
    return host_block(qs, pinned=device.type == "cuda").to(
        device, non_blocking=True)


class QueryBackend:
    """Base class / protocol for batched query execution. `mesh` is taken
    by every backend for a uniform constructor; only "sharded" uses it."""

    name: str = "abstract"
    _degrade_level: int = 0

    def __init__(self, mesh=None):
        self.mesh = mesh

    def degrade(self, level: int) -> None:
        """Degrade-ladder hook (`serve.degrade`): rung `level` holds until
        the next call (0 = normal serving). The base backend has no
        cheaper mode and only records the level; the pruned backend lifts
        its union cap, and wrappers pass the level inward."""
        self._degrade_level = int(level)

    def bound_ranks(self, rt: RankTable, users: torch.Tensor,
                    qs: torch.Tensor):
        """§4.3 step 1 for a (B, d) block → (r↓, r↑, est), each (B, n)."""
        raise NotImplementedError

    def select(self, rt: RankTable, r_lo, r_up, est, *, k: int,
               c: float) -> QueryResult:
        """§4.3 steps 2-3 on (B, n) bounds."""
        return query_mod.select_topk(r_lo, r_up, est, k=k, c=c,
                                     m_items=rt.m)

    def build_index(self, users: torch.Tensor, items: torch.Tensor,
                    cfg: RankTableConfig,
                    generator: Optional[torch.Generator] = None, *,
                    positions=None, weights=None) -> RankTable:
        """Algorithm 1 on this backend's substrate."""
        return rt_mod.build_rank_table(users, items, cfg, generator,
                                       positions=positions, weights=weights)

    def check_users_shape(self, n: int) -> None:
        """Raise ValueError if this backend cannot query n users. The
        engine calls it before an append publishes, and before a
        compacting rebuild drops rows (which it then skips)."""

    def _delta_query(self, rt: RankTable, users, qs: torch.Tensor, *,
                     k: int, c: float, delta: DeltaCorrection
                     ) -> QueryResult:
        """The delta path of a backend with full (B, n) bounds: its step
        1, the shared correction on u·q (one more (n, d) × (d, B) f32
        product, with the slack of quantized users), then the selection
        at `delta.selection_m()`."""
        with trace.span("query.step1"):
            r_lo, r_up, est = self.bound_ranks(rt, users, qs)   # (B, n)
        scores, slack = query_mod.user_scores_batch(users, qs)  # (n, B)
        r_lo, r_up, est = rt_mod.apply_delta_corrections(
            scores, r_lo.T, r_up.T, est.T, delta, slack=slack)
        return query_mod.select_topk(r_lo.T, r_up.T, est.T, k=k, c=c,
                                     m_items=delta.selection_m())

    def query_batch(self, rt: RankTable, users: torch.Tensor,
                    qs: torch.Tensor, *, k: int, c: float,
                    delta: Optional[DeltaCorrection] = None) -> QueryResult:
        """One batch: step 1 (`bound_ranks`) then the selection, inside
        the batch's root span `query.batch`, step 1 inside `query.step1`
        (the selection's spans are `select_topk`'s)."""
        with trace.span("query.batch"):
            if delta is not None:
                return self._delta_query(rt, users, qs, k=k, c=c,
                                         delta=delta)
            with trace.span("query.step1"):
                r_lo, r_up, est = self.bound_ranks(rt, users, qs)
            return self.select(rt, r_lo, r_up, est, k=k, c=c)


    def dispatch_device(self, rt: RankTable, users, qs, *, k: int,
                        c: float, delta: Optional[DeltaCorrection] = None
                        ) -> QueryResult:
        """Serving entry: a HOST (B, d) block (numpy or a CPU tensor) is
        staged on the device in one copy (`stage_block`), and the tick's
        QueryResult comes back as device tensors with no host sync; the
        caller copies it to the host. Values are bitwise those of
        `query_batch` on the same block."""
        qs = stage_block(qs, stored_rows(users).device)
        if delta is None:
            return self.query_batch(rt, users, qs, k=k, c=c)
        return self.query_batch(rt, users, qs, k=k, c=c, delta=delta)


_REGISTRY: Dict[str, Type[QueryBackend]] = {}
_WRAPPERS: Dict[str, Callable[[str], QueryBackend]] = {}
# Wrapper prefixes that resolve by importing their module on first use
# (these modules import this one, so they cannot be imported here)
_LAZY_WRAPPERS = {"cached": "repro_torch.serve.cache",
                  "elastic": "repro_torch.core.elastic"}


def register_backend(name: str):
    """Class decorator: register a QueryBackend under `name`."""
    def deco(cls: Type[QueryBackend]) -> Type[QueryBackend]:
        if "name" not in cls.__dict__:
            cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def register_wrapper(prefix: str):
    """Register `factory(inner_name, *, mesh=None) -> QueryBackend` under
    `prefix`, making `"<prefix>:<inner>"` a resolvable backend spec."""
    def deco(factory):
        _WRAPPERS[prefix] = factory
        return factory
    return deco


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def get_backend(spec, *, mesh=None) -> QueryBackend:
    """Resolve a registered name, a `"<wrapper>:<inner>"` spec, or an
    already-built instance; anything else raises ValueError. `mesh`
    reaches the backends a spec names (an instance keeps its own)."""
    if isinstance(spec, QueryBackend):
        if mesh is not None:
            raise ValueError(
                "mesh= only applies when the backend is given by NAME; "
                "construct the instance with its mesh instead")
        return spec
    if isinstance(spec, str) and ":" in spec:
        prefix, _, inner = spec.partition(":")
        factory = _WRAPPERS.get(prefix)
        if factory is None and prefix in _LAZY_WRAPPERS:
            importlib.import_module(_LAZY_WRAPPERS[prefix])
            factory = _WRAPPERS.get(prefix)
        if factory is None:
            raise ValueError(f"unknown backend wrapper {prefix!r} in "
                             f"{spec!r}; registered: {sorted(_WRAPPERS)}")
        return factory(inner, mesh=mesh)
    try:
        cls = _REGISTRY[spec]
    except (KeyError, TypeError):
        raise ValueError(f"unknown query backend {spec!r}; available: "
                         f"{available_backends()}") from None
    obj = cls(mesh=mesh)
    obj.name = spec
    return obj


def _stock_pipeline(backend: QueryBackend, cls: Type[QueryBackend]) -> bool:
    """True when the instance uses `cls`'s own `bound_ranks` and the base
    `select`: only then is an end-to-end fast path (the elastic program)
    the same computation as bound_ranks + select, and a subclass that
    overrides either hook keeps the composed path."""
    t = type(backend)
    return (t.select is QueryBackend.select
            and t.bound_ranks is cls.bound_ranks)


@register_backend("dense")
class DenseBackend(QueryBackend):
    """Plain PyTorch step 1."""

    def bound_ranks(self, rt, users, qs):
        return query_mod.bound_ranks_batch(rt, users, qs)

    def query_batch(self, rt, users, qs, *, k, c, delta=None):
        if delta is None:
            return super().query_batch(rt, users, qs, k=k, c=c)
        # the correction reuses step 1's score product
        return query_mod.query_batch_delta(rt, users, qs, delta, k, c)


@register_backend("fused")
class FusedBackend(QueryBackend):
    """Step 1 in the K1, K4 or K5 kernel on CUDA tensors."""

    def bound_ranks(self, rt, users, qs):
        return ops.bound_ranks_batched_stored(users, qs.contiguous(), rt)


@register_backend("sharded")
class ShardedBackend(QueryBackend):
    """Row-sharded execution over a mesh with the tree merge
    (`core.distributed`).

    `query_batch` gathers only (B, k·P) candidates, so its QueryResult
    carries candidate-set bounds of shape (B, k·P); on a mutated index
    the correction runs on each shard's rows before its top-k. Built
    query functions are cached by (k, c, n, delta widths, spec, stored
    users), as the reference keys its compiled ones. `bound_ranks` gives
    the dense (B, n) bounds, for parity checks only.

    `build_index` builds through `distributed.build_sharded`, for
    `Engine.build` and for every rebuild, and takes the dense build for
    threshold_mode="exact" and where n or m is not a multiple of P
    (churn drifts the live m off it); `build_fallback` says which ran
    ("" sharded, else "exact" or "shape").

    With mesh=None the mesh is resolved at first use from the users'
    device (`distributed.flat_mesh(device=...)`: every CUDA device, or
    the CPU)."""

    def __init__(self, mesh=None):
        super().__init__(
            mesh=None if mesh is None else distributed.flat_mesh(mesh))
        self._fns: dict = {}
        self.build_fallback = ""

    def mesh_for(self, device) -> tuple:
        """The mesh, resolved from `device` if none was given."""
        if self.mesh is None:
            self.mesh = distributed.flat_mesh(device=device)
        return self.mesh

    def bound_ranks(self, rt, users, qs):
        return query_mod.bound_ranks_batch(rt, users, qs)

    def build_index(self, users, items, cfg, generator=None, *,
                    positions=None, weights=None):
        P = len(self.mesh_for(users.device))
        if cfg.threshold_mode == "exact" or users.shape[0] % P \
                or items.shape[0] % P:
            # the exact range needs every user against the full item set;
            # an n or m off the mesh multiple cannot split evenly (a
            # rebuild would fail on every retry): build dense, which
            # queries fine here as long as n itself splits
            self.build_fallback = ("exact" if cfg.threshold_mode == "exact"
                                   else "shape")
            return super().build_index(users, items, cfg, generator,
                                       positions=positions, weights=weights)
        if positions is None:
            positions, weights = rt_mod.stratified_sample_indices(
                items.shape[0], cfg, generator, device=users.device)
        elif weights is None:
            raise ValueError("positions= needs weights= as well")
        self.build_fallback = ""
        return distributed.build_sharded(users, items, cfg, positions,
                                         weights, self.mesh)

    def check_users_shape(self, n):
        # an unresolved mesh would be every CUDA device, or the CPU
        P = (len(self.mesh) if self.mesh is not None
             else torch.cuda.device_count() if torch.cuda.is_available()
             else 1)
        if n % P:
            raise ValueError(
                f"sharded backend row-shards {n} users over {P} devices; "
                "appends must keep n divisible by the mesh size (pad the "
                "append batch or rebuild on a resized mesh)")

    def query_batch(self, rt, users, qs, *, k, c, delta=None):
        mesh = self.mesh_for(stored_rows(users).device)
        n = users.shape[0]
        shape = None if delta is None else (delta.n_add, delta.n_del)
        key = (k, float(c), n, shape, rt.spec_kind,
               isinstance(users, StoredUsers))
        fn = self._fns.get(key)
        if fn is None:
            fn = distributed.make_batch_query_fn(
                mesh, k=k, n=n, c=float(c), with_delta=delta is not None)
            self._fns[key] = fn
        return fn(rt, users, qs, delta)


@register_backend("pruned")
class PrunedBackend(QueryBackend):
    """Two-phase block-pruned execution around an inner backend.

    Phase A scores the per-block summaries against the whole query block
    and keeps the user tiles that can still hold an answer; phase B runs
    the inner backend's step 1 over the kept tiles only, and skipped
    users read the dominated sentinel m + 2, so the selection returns
    the full scan's indices bit for bit (`core.pruning`):

      pruned:dense   gathered rows, `pruning.pruned_query_batch`;
      pruned:fused   K6 (f32) or K7 (bf16, int8) over the kept tiles on
                     CUDA tensors, their plain versions on CPU tensors
                     (`ops.bound_ranks_batched_pruned_stored`);
      pruned:sharded each shard gathers its own kept tiles before the
                     unchanged tree merge
                     (`distributed.make_pruned_batch_query_fn`), with
                     candidate-set bounds (B, k·P);
      other inners   the inner's `bound_ranks` on the gathered rows.

    On a mutated index (`delta=`) phase A widens its envelopes by the
    delta's padded widths and counts only live users, and phase B
    corrects the kept rows (`pruning.pruned_query_batch_delta`, or the
    kernel's bounds then `pruning.delta_finish_compacted`).

    Summaries are cached by the identity of (users, thresholds, table),
    four generations, each entry holding references to its arrays so
    that their ids cannot be reused while it lives; a mutation publishes
    new arrays, so it keys a new summary. Phase A's keep mask is read on
    the host: when its union exceeds `max_union_frac` of the blocks, the
    inner backend runs the full scan instead (`stats.fallback =
    "dense"`); when the delta exceeds `pruning.DELTA_GUARD` of the base
    items, phase A is skipped and the inner runs the full scan
    (`stats.fallback = "delta-guard"`); on a sharded inner whose n does
    not split into whole blocks per shard (n % (P·block_size)), the inner
    runs unpruned (`stats.fallback = "align"`). `use_cones=False` prunes
    on the coordinate boxes alone.
    """

    _SUMMARY_CACHE = 4          # index generations kept

    def __init__(self, inner="dense", *, mesh=None,
                 block_size: Optional[int] = None,
                 max_union_frac: float = 0.5, use_cones: bool = True):
        super().__init__(mesh=mesh)
        self.inner = get_backend(inner, mesh=mesh)
        self.name = f"pruned:{self.inner.name}"
        self.block_size = int(block_size or pruning.DEFAULT_BLOCK)
        self.max_union_frac = float(max_union_frac)
        self.use_cones = bool(use_cones)
        self._summaries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._sharded_fns: dict = {}
        self.stats = pruning.PruneStats()   # last query_batch's accounting

    def bound_ranks(self, rt, users, qs):
        """Full (B, n) bounds come from the inner backend: pruning
        applies to the end-to-end query."""
        return self.inner.bound_ranks(rt, users, qs)

    def build_index(self, users, items, cfg, generator=None, *,
                    positions=None, weights=None):
        rt = self.inner.build_index(users, items, cfg, generator,
                                    positions=positions, weights=weights)
        self.summary_for(rt, users)         # pre-warm this generation
        return rt

    def check_users_shape(self, n):
        return self.inner.check_users_shape(n)

    def degrade(self, level):
        """Rung ≥ 1 lifts `max_union_frac` to 1.0: a query that prunes
        poorly pays the two-phase scan over its kept blocks instead of a
        full-scan latency spike. Bounds and results are unchanged."""
        super().degrade(level)
        self.inner.degrade(level)

    def summary_for(self, rt: RankTable, users) -> pruning.BlockSummary:
        """The `BlockSummary` of this index generation (identity-cached)."""
        key = (id(users), id(rt.thresholds), id(rt.table), self.block_size,
               self.use_cones)
        hit = self._summaries.get(key)
        if hit is not None:
            self._summaries.move_to_end(key)
            return hit[1]
        summary = pruning.build_block_summary(
            users, rt, block_size=self.block_size, with_cones=self.use_cones)
        self._summaries[key] = ((users, rt.thresholds, rt.table), summary)
        while len(self._summaries) > self._SUMMARY_CACHE:
            self._summaries.popitem(last=False)
        return summary

    def query_batch(self, rt, users, qs, *, k, c, delta=None):
        with trace.span("prune.query", batch=qs.shape[0], k=k):
            res = self._query_impl(rt, users, qs, k=k, c=c, delta=delta)
        # this batch's accounting (skip rate, kept fraction, fallback) as
        # gauges: the live half of the bench's prune columns
        self.stats.publish()
        return res

    def _full_scan(self, rt, users, qs, *, k, c, delta, why: str,
                   n_blocks: int) -> QueryResult:
        self.stats = pruning.PruneStats(
            n_blocks=n_blocks, kept_union=n_blocks, kept_per_query=1.0,
            fallback=why)
        return self.inner.query_batch(rt, users, qs, k=k, c=c, delta=delta)

    def _query_impl(self, rt, users, qs, *, k, c, delta=None):
        n = users.shape[0]
        bs = self.block_size
        nb = -(-n // bs)
        sharded = isinstance(self.inner, ShardedBackend)
        if sharded and n % (len(self.inner.mesh_for(
                stored_rows(users).device)) * bs):
            # a tile must not straddle two shards: run the inner unpruned
            return self._full_scan(rt, users, qs, k=k, c=c, delta=delta,
                                   why="align", n_blocks=nb)
        if delta is not None and (delta.n_add + delta.n_del) / max(
                rt.m, 1) > pruning.DELTA_GUARD:
            # the envelopes widened by the (padded) delta widths would
            # keep nearly every block: run the inner full scan
            return self._full_scan(rt, users, qs, k=k, c=c, delta=delta,
                                   why="delta-guard", n_blocks=nb)
        with trace.span("prune.phase_a", n_blocks=nb) as sp_a:
            summary = self.summary_for(rt, users)
            if delta is None:
                keep, _ = pruning.phase_a(summary, qs, k=k)
            else:
                keep, _ = pruning.phase_a(summary, qs, k=k,
                                          n_add=delta.n_add,
                                          n_del=delta.n_del,
                                          user_live=delta.user_live,
                                          block_size=bs)
            keep_np = keep.cpu().numpy()                    # host sync
            union = np.flatnonzero(keep_np.any(axis=0))
            per_q = float(keep_np.mean())
            sp_a.set(kept_union=int(union.size))
        self.stats = pruning.PruneStats(
            n_blocks=nb, kept_union=int(union.size), kept_per_query=per_q)
        # degrade rung ≥ 1 lifts the union cap to 1.0: the fallback is
        # then unreachable (union ≤ nb)
        union_cap = (1.0 if self._degrade_level >= 1
                     else self.max_union_frac)
        if union.size > union_cap * nb:
            self.stats.fallback = "dense"
            return self.inner.query_batch(rt, users, qs, k=k, c=c,
                                          delta=delta)
        with trace.span("prune.phase_b", kept=int(union.size),
                        n_blocks=nb):
            if sharded:
                return self._sharded_query(rt, users, qs, keep, keep_np,
                                           k=k, c=c, delta=delta)
            return self._phase_b(rt, users, qs, keep, union, k=k, c=c,
                                 delta=delta)

    def _sharded_query(self, rt, users, qs, keep, keep_np, *, k, c, delta):
        """Phase B on a sharded inner: each shard's kept local block ids,
        padded to one bucketed width by repeating them (`valid` False on
        the repeats), then the pruned tree merge."""
        mesh = self.inner.mesh
        P = len(mesh)
        n = users.shape[0]
        bs = self.block_size
        nb_loc = keep_np.shape[1] // P
        per_shard = keep_np.any(axis=0).reshape(P, nb_loc)
        width = pruning.bucket_width(int(per_shard.sum(axis=1).max()),
                                     n_blocks=nb_loc,
                                     min_blocks=-(-k // bs))
        ids = np.zeros((P, width), np.int64)
        valid = np.zeros((P, width), bool)
        for s in range(P):
            kept = np.flatnonzero(per_shard[s])
            if kept.size == 0:
                continue                    # ids stay 0, valid stays False
            ids[s] = np.tile(kept, -(-width // kept.size))[:width]
            valid[s, :kept.size] = True
        shape = None if delta is None else (delta.n_add, delta.n_del)
        fkey = (k, float(c), n, width, shape)
        fn = self._sharded_fns.get(fkey)
        if fn is None:
            fn = distributed.make_pruned_batch_query_fn(
                mesh, k=k, n=n, c=float(c), block_size=bs,
                with_delta=delta is not None)
            self._sharded_fns[fkey] = fn
        return fn(rt, users, qs, ids, valid, keep, delta)

    def _phase_b(self, rt, users, qs, keep, union, *, k, c, delta):
        """Step 1 over the kept tiles, then the selection (module doc of
        `core.pruning`)."""
        n = users.shape[0]
        bs = self.block_size
        nb = -(-n // bs)
        ids_np = pruning.bucket_blocks(union, n_blocks=nb,
                                       min_blocks=-(-k // bs))
        ids = torch.from_numpy(ids_np).to(qs.device)
        # padding tiles repeat kept ids; marking them invalid keeps a user
        # from being a candidate twice
        blk_valid = torch.from_numpy(
            np.arange(ids_np.size) < max(union.size, 1)).to(qs.device)
        if type(self.inner) is DenseBackend:
            if delta is None:
                return pruning.pruned_query_batch(
                    rt, users, qs, ids, blk_valid, keep, k, c, block_size=bs)
            return pruning.pruned_query_batch_delta(
                rt, users, qs, delta, ids, blk_valid, keep, k, c,
                block_size=bs)
        if type(self.inner) is FusedBackend:
            r_lo, r_up, est = ops.bound_ranks_batched_pruned_stored(
                users, qs.contiguous(), rt, ids, block_n=bs)
        else:
            g = torch.clamp(pruning.row_indices(ids, bs), max=n - 1)
            r_lo, r_up, est = self.inner.bound_ranks(
                rt.take_rows(g), take_user_rows(users, g), qs)
        if delta is None:
            return pruning.finish_compacted(r_lo, r_up, est, ids, blk_valid,
                                            keep, rt.m, k, c, n, bs)
        return pruning.delta_finish_compacted(users, qs, delta, r_lo, r_up,
                                              est, ids, blk_valid, keep, k,
                                              c, n, bs)


@register_wrapper("pruned")
def _make_pruned(inner: str, *, mesh=None) -> PrunedBackend:
    """`get_backend("pruned:<inner>")` lands here."""
    return PrunedBackend(inner, mesh=mesh)
