"""Pluggable query-execution backends.

Counterpart of `repro/core/backends.py`, with two registered backends:

  "dense" — plain PyTorch step 1 (`core.query`): one (n, d)×(d, B)
            product plus one pass over the table per batch;
  "fused" — step 1 in a kernel (`kernels.ops.bound_ranks_batched_stored`:
            K1 on an f32 table, K4 on bf16, K5 on int8) on CUDA
            tensors; its plain version on CPU tensors.

`users` is the raw (n, d) matrix at f32 storage and `StoredUsers` at
bf16 and int8.

and one registered wrapper:

  "pruned:<inner>" — block-pruned execution (`core.pruning`): phase A
            keeps the user tiles that can hold answers, phase B runs
            step 1 on them only ("pruned" alone is "pruned:dense").

`bound_ranks` takes a (B, d) block and returns (B, n) bounds; `select`
realizes §4.3 steps 2-3; `query_batch` composes the two. Wrapper specs
`"<prefix>:<inner>"` resolve through `register_wrapper`.

On a mutated index `query_batch(..., delta=DeltaCorrection)` folds the
delta buffer in between step 1 and the selection, through the one
shared `rank_table.apply_delta_corrections`, so the backends cannot
drift apart: dense in `query.query_batch_delta`, fused (and any backend
with full (B, n) bounds) in `_delta_query`, the pruned wrapper in phase
B on the kept rows.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Type

import numpy as np
import torch

from repro_torch.core import pruning
from repro_torch.core import query as query_mod
from repro_torch.core import rank_table as rt_mod
from repro_torch.core.types import DeltaCorrection, QueryResult, \
    RankTable, RankTableConfig, take_user_rows
from repro_torch.kernels import ops


class QueryBackend:
    """Base class / protocol for batched query execution."""

    name: str = "abstract"

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

    def _delta_query(self, rt: RankTable, users, qs: torch.Tensor, *,
                     k: int, c: float, delta: DeltaCorrection
                     ) -> QueryResult:
        """The delta path of a backend with full (B, n) bounds: its step
        1, the shared correction on u·q (one more (n, d) × (d, B) f32
        product, with the slack of quantized users), then the selection
        at `delta.selection_m()`."""
        r_lo, r_up, est = self.bound_ranks(rt, users, qs)   # (B, n)
        scores, slack = query_mod.user_scores_batch(users, qs)  # (n, B)
        r_lo, r_up, est = rt_mod.apply_delta_corrections(
            scores, r_lo.T, r_up.T, est.T, delta, slack=slack)
        return query_mod.select_topk(r_lo.T, r_up.T, est.T, k=k, c=c,
                                     m_items=delta.selection_m())

    def query_batch(self, rt: RankTable, users: torch.Tensor,
                    qs: torch.Tensor, *, k: int, c: float,
                    delta: Optional[DeltaCorrection] = None) -> QueryResult:
        if delta is not None:
            return self._delta_query(rt, users, qs, k=k, c=c, delta=delta)
        r_lo, r_up, est = self.bound_ranks(rt, users, qs)
        return self.select(rt, r_lo, r_up, est, k=k, c=c)


_REGISTRY: Dict[str, Type[QueryBackend]] = {}
_WRAPPERS: Dict[str, Callable[[str], QueryBackend]] = {}


def register_backend(name: str):
    """Class decorator: register a QueryBackend under `name`."""
    def deco(cls: Type[QueryBackend]) -> Type[QueryBackend]:
        if "name" not in cls.__dict__:
            cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def register_wrapper(prefix: str):
    """Register `factory(inner_name) -> QueryBackend` under `prefix`,
    making `"<prefix>:<inner>"` a resolvable backend spec."""
    def deco(factory):
        _WRAPPERS[prefix] = factory
        return factory
    return deco


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def get_backend(spec) -> QueryBackend:
    """Resolve a registered name, a `"<wrapper>:<inner>"` spec, or an
    already-built instance; anything else raises ValueError."""
    if isinstance(spec, QueryBackend):
        return spec
    if isinstance(spec, str) and ":" in spec:
        prefix, _, inner = spec.partition(":")
        factory = _WRAPPERS.get(prefix)
        if factory is None:
            raise ValueError(f"unknown backend wrapper {prefix!r} in "
                             f"{spec!r}; registered: {sorted(_WRAPPERS)}")
        return factory(inner)
    try:
        cls = _REGISTRY[spec]
    except (KeyError, TypeError):
        raise ValueError(f"unknown query backend {spec!r}; available: "
                         f"{available_backends()}") from None
    obj = cls()
    obj.name = spec
    return obj


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
    (`stats.fallback = "delta-guard"`). `use_cones=False` prunes on the
    coordinate boxes alone.
    """

    _SUMMARY_CACHE = 4          # index generations kept

    def __init__(self, inner="dense", *, block_size: Optional[int] = None,
                 max_union_frac: float = 0.5, use_cones: bool = True):
        self.inner = get_backend(inner)
        self.name = f"pruned:{self.inner.name}"
        self.block_size = int(block_size or pruning.DEFAULT_BLOCK)
        self.max_union_frac = float(max_union_frac)
        self.use_cones = bool(use_cones)
        self._summaries: "OrderedDict[tuple, tuple]" = OrderedDict()
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
        n = users.shape[0]
        bs = self.block_size
        nb = -(-n // bs)
        if delta is not None and (delta.n_add + delta.n_del) / max(
                rt.m, 1) > pruning.DELTA_GUARD:
            # the envelopes widened by the (padded) delta widths would
            # keep nearly every block: run the inner full scan
            self.stats = pruning.PruneStats(
                n_blocks=nb, kept_union=nb, kept_per_query=1.0,
                fallback="delta-guard")
            return self.inner.query_batch(rt, users, qs, k=k, c=c,
                                          delta=delta)
        summary = self.summary_for(rt, users)
        if delta is None:
            keep, _ = pruning.phase_a(summary, qs, k=k)
        else:
            keep, _ = pruning.phase_a(summary, qs, k=k, n_add=delta.n_add,
                                      n_del=delta.n_del,
                                      user_live=delta.user_live,
                                      block_size=bs)
        keep_np = keep.cpu().numpy()                        # host sync
        union = np.flatnonzero(keep_np.any(axis=0))
        per_q = float(keep_np.mean())
        self.stats = pruning.PruneStats(
            n_blocks=nb, kept_union=int(union.size), kept_per_query=per_q)
        if union.size > self.max_union_frac * nb:
            self.stats.fallback = "dense"
            return self.inner.query_batch(rt, users, qs, k=k, c=c,
                                          delta=delta)
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
def _make_pruned(inner: str) -> PrunedBackend:
    """`get_backend("pruned:<inner>")` lands here."""
    return PrunedBackend(inner)
