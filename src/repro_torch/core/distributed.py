"""Row-sharded execution: the sharded build, the tree-merge query, its
block-pruned twin and the ring exact ranks.

Counterpart of `repro/core/distributed.py`, on one controller. A mesh is
a tuple of `torch.device`s (`flat_mesh`); one process issues every
shard's work on that shard's device, as the reference's `shard_map` runs
one program over the devices one process sees. A device may repeat: P
shards on one card (or on the CPU) run exactly the merge that P cards
run.

Layout, as in the reference:
  * users and rank-table rows are split evenly by rows over the mesh
    (every (n, ·) field, the int8 scale/offset vectors and the stored
    users' scale and slack included; m and m' are replicated). A shard
    on the device that holds the tensor is a row view, no copy; shards
    are cached per snapshot tensor (`split_state`), so a query never
    re-splits, and a mutation, which publishes new tensors, splits anew;
  * items are split the same way for the build's norm pass and the ring;
    the samples and max ‖p‖ are replicated;
  * a query block is replicated; step 1 is local (the dense math of
    `core.query` on the shard's rows); the global top-k is a TREE MERGE:
    each shard's k smallest r↓ and r↑ go to the lead device (the first
    of the mesh), whose k-th smallest of the union is the exact global
    R↓_k / R↑_k; these go back to every shard, which takes its k best
    users by the §4.3 composite key (`query.lemma1_key`); the (B, k, 3)
    candidates and their global indices are gathered in shard order and
    `query.lemma1_select` runs on the lead.

What crosses devices per BATCH of B queries is O(B·k·P) values in three
steps whatever B is (`COLLECTIVES` counts them, one per step per call),
carried by `Tensor.to(lead, non_blocking=True)`. Nothing inside a query
call reads a value back to the host, so work on P distinct cards is
issued without waiting on any one of them.

The reference shards only evenly: `build_sharded` needs n and m
divisible by P, the pruned query n divisible by P·block_size, and the
query n divisible by P; each raises otherwise. `ShardedBackend` and
`PrunedBackend` (`core.backends`) take the reference's fallbacks before
that.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core import rank_table as rt_mod
from repro_torch.core.query import lemma1_key, lemma1_select, \
    lookup_bounds_batch, smallest_k, squeeze_result, user_scores_batch
from repro_torch.core.types import DeltaCorrection, QueryResult, \
    RankTable, RankTableConfig, StoredUsers, kth_smallest, take_user_rows
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

# Cross-shard steps of the tree merge, one each per query call whatever
# B is (the reference's one-collective schedule): the per-shard order
# statistics gathered to the lead, R↓_k / R↑_k sent back to the shards,
# the candidates gathered to the lead.
COLLECTIVES = {"gather_stats": 0, "send_stats": 0, "gather_candidates": 0}


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def flat_mesh(devices=None, *, device=None) -> tuple:
    """The engine's 1-D mesh: a tuple of `torch.device`, one per shard.

    `devices` is a device, a name, or a sequence of them; a device may
    repeat, and then several shards share it. None gives every visible
    CUDA device, or `(cpu,)` when `device` is the CPU (None for `device`
    means the card, which must then exist)."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            return (dev,)
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if isinstance(devices, (str, torch.device)):
        devices = (devices,)
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return tuple(out)


def _on(dev: torch.device):
    """Make `dev` the current CUDA device (its current stream is where a
    kernel wrapper launches); a no-op on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x if x.device == dev else x.to(dev, non_blocking=True)


def _need_even(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what}: {n} rows do not split evenly over "
                         f"{parts} shards")
    return n // parts


def shard_rows(x: Optional[torch.Tensor], mesh: tuple) -> tuple:
    """x's rows split evenly over the mesh, in order: on x's own device a
    shard is a row view, elsewhere a copy. None gives P Nones."""
    if x is None:
        return (None,) * len(mesh)
    sn = _need_even(x.shape[0], len(mesh), "shard_rows")
    return tuple(_to(x[s * sn:(s + 1) * sn], dev)
                 for s, dev in enumerate(mesh))


def _shard_table(rt: RankTable, mesh: tuple) -> tuple:
    """Every row-aligned field of `rt` split by rows; m replicated."""
    fields = {f: shard_rows(getattr(rt, f), mesh)
              for f in ("thresholds", "table") + RankTable._QUANT_FIELDS}
    return tuple(RankTable(m=rt.m, **{f: v[s] for f, v in fields.items()})
                 for s in range(len(mesh)))


def _shard_users(users, mesh: tuple) -> tuple:
    """A raw (n, d) matrix or `StoredUsers` (rows, scale, slack) by rows."""
    if not isinstance(users, StoredUsers):
        return shard_rows(users, mesh)
    parts = [shard_rows(a, mesh) for a in users]
    return tuple(StoredUsers(*(p[s] for p in parts))
                 for s in range(len(mesh)))


def _shard_corr(corr: Optional[DeltaCorrection], mesh: tuple) -> tuple:
    """A delta correction's per-user fields by rows; m' replicated."""
    if corr is None:
        return (None,) * len(mesh)
    fields = {f: shard_rows(getattr(corr, f), mesh)
              for f in DeltaCorrection._fields if f != "m_new"}
    return tuple(DeltaCorrection(m_new=corr.m_new,
                                 **{f: v[s] for f, v in fields.items()})
                 for s in range(len(mesh)))


# Split states kept, newest last: one per index generation, as the pruned
# backend keeps its summaries. Each entry holds its source tensors, so
# their ids cannot be reused while it lives.
_SPLITS: "OrderedDict[tuple, tuple]" = OrderedDict()
_SPLIT_CACHE = 4
_SPLIT_LOCK = threading.Lock()


def split_state(rt: RankTable, users, corr: Optional[DeltaCorrection],
                mesh: tuple) -> tuple:
    """(rank tables, users, corrections) of each shard, cached by the
    identity of every tensor split."""
    user_parts = users if isinstance(users, StoredUsers) else (users,)
    srcs = tuple(t for t in (*rt, *user_parts, *(corr or ()))
                 if isinstance(t, torch.Tensor))
    key = (mesh, rt.m, None if corr is None else corr.m_new) \
        + tuple(id(t) for t in srcs)
    with _SPLIT_LOCK:
        hit = _SPLITS.get(key)
        if hit is not None:
            _SPLITS.move_to_end(key)
            return hit[1]
    out = (_shard_table(rt, mesh), _shard_users(users, mesh),
           _shard_corr(corr, mesh))
    with _SPLIT_LOCK:
        _SPLITS[key] = (srcs, out)
        while len(_SPLITS) > _SPLIT_CACHE:
            _SPLITS.popitem(last=False)
    return out


# ------------------------------------------------------------------- build
def build_sharded(users: torch.Tensor, items: torch.Tensor,
                  cfg: RankTableConfig, positions: torch.Tensor,
                  weights: torch.Tensor, mesh: tuple) -> RankTable:
    """Algorithm 1 over the mesh, from given sample positions (into the
    norm-descending order) and weights.

    The norm pass runs per item shard; the m norms are gathered to the
    lead and sorted there (descending, stable, as `sort_items_by_norm`);
    the samples and max ‖p‖ are replicated; each shard then builds its
    own rows as the dense build does: the threshold range from the
    shard's product with the samples, the grid, Eq. (1) through
    `ops.build_table_rows` (K2 on the card, once a shard) and
    `cfg.storage.pack_table`. The packed rows come back to the lead in
    shard order.

    threshold_mode="exact" raises, as in the reference: its f_min/f_max
    needs every user row against the full item set, which this
    row-parallel build never forms (build it dense)."""
    if cfg.threshold_mode == "exact":
        raise ValueError(
            'build_sharded does not support threshold_mode="exact" (each '
            "user shard only sees its item shard); use the dense "
            "build_rank_table for the exact-threshold oracle mode")
    mesh = flat_mesh(mesh)
    lead = mesh[0]
    m = items.shape[0]
    _need_even(users.shape[0], len(mesh), "build_sharded users")
    _need_even(m, len(mesh), "build_sharded items")
    norm_parts = []
    for dev, it in zip(mesh, shard_rows(items, mesh)):
        with _on(dev):
            norm_parts.append(torch.linalg.norm(it.to(torch.float32),
                                                dim=1))
    norms = torch.cat([_to(x, lead) for x in norm_parts])
    order = torch.argsort(-norms, stable=True)
    positions = positions.to(device=lead, dtype=torch.int64)
    samples = _to(items, lead)[order[positions]].contiguous()
    weights = weights.to(device=lead, dtype=torch.float32)
    max_norm = norms[order[0]]
    packed = []
    for dev, u in zip(mesh, shard_rows(users, mesh)):
        with _on(dev):
            smp, w, mx = (_to(samples, dev), _to(weights, dev),
                          _to(max_norm, dev))
            u = u.contiguous()
            scores = u @ smp.T
            smin, smax = rt_mod._threshold_range(u, None, scores, cfg,
                                                 max_norm=mx)
            del scores              # K2 computes its own, as in the build
            thr = rt_mod.threshold_grid(smin, smax, cfg.tau).contiguous()
            table = ops.build_table_rows(u, smp, w, thr)
            packed.append(cfg.storage.pack_table(thr, table, m=m))
    cat = lambda f: (None if getattr(packed[0], f) is None
                     else torch.cat([_to(getattr(p, f), lead)
                                     for p in packed]))
    return RankTable(m=m, **{f: cat(f) for f in
                             ("thresholds", "table")
                             + RankTable._QUANT_FIELDS})


# ------------------------------------------------------------------- query
def _local_bounds(rt_s: RankTable, u_s, qs: torch.Tensor,
                  corr_s: Optional[DeltaCorrection]):
    """A shard's step 1 (the dense math) and, on a mutated index, its
    delta correction, before any selection → (r_lo, r_up, est), each
    (B, rows), query-major."""
    scores, slack = user_scores_batch(u_s, qs)              # (rows, B)
    r_lo, r_up, est = lookup_bounds_batch(rt_s, scores, slack)
    if corr_s is not None:
        r_lo, r_up, est = rt_mod.apply_delta_corrections(
            scores, r_lo, r_up, est, corr_s, slack=slack)
    return r_lo.T, r_up.T, est.T


def _tree_merge(mesh: tuple, bounds: list, rows: list, *, k: int, c: float,
                m_items) -> QueryResult:
    """The merge over each shard's (r_lo, r_up, est), (B, w_s) on its
    device, whose column j is the shard's global row `rows[s][j]`.

    The k smallest r↓ and r↑ of each shard (values; `topk`'s tie order
    does not matter) are gathered to the lead; their k-th smallest is
    the exact global R↓_k / R↑_k, which goes back to every shard; each
    shard takes its k best by the composite key (ties to the lower row)
    and the (B, k·P) candidates come to the lead in shard order, where
    the same key selects again. A tie across shards goes to the lower
    shard, so to the lower global row: the result is `select_topk`'s
    over the concatenated bounds."""
    lead = mesh[0]
    stats = []
    for dev, (r_lo, r_up, _) in zip(mesh, bounds):
        if r_lo.shape[-1] < k:
            raise ValueError(f"k={k} exceeds the {r_lo.shape[-1]} rows a "
                             "shard holds")
        with _on(dev):
            stats.append(torch.stack([
                torch.topk(r_lo, k, dim=-1, largest=False).values,
                torch.topk(r_up, k, dim=-1, largest=False).values]))
    all_stats = torch.cat([_to(x, lead) for x in stats], dim=-1)
    COLLECTIVES["gather_stats"] += 1
    R = torch.stack([kth_smallest(all_stats[0], k),
                     kth_smallest(all_stats[1], k)])        # (2, B)
    R_back = [_to(R, dev) for dev in mesh]
    COLLECTIVES["send_stats"] += 1
    payloads, gidx = [], []
    for dev, (r_lo, r_up, est), rows_s, R_s in zip(mesh, bounds, rows,
                                                   R_back):
        with _on(dev):
            key, _, _, _ = lemma1_key(r_lo, r_up, est, R_lo_k=R_s[0],
                                      R_up_k=R_s[1], c=c, m_items=m_items)
            cand = smallest_k(key, k)                       # (B, k)
            payloads.append(torch.stack(
                [torch.gather(x, -1, cand) for x in (est, r_lo, r_up)],
                dim=-1))                                    # (B, k, 3)
            gidx.append(rows_s[cand])
    payload = torch.cat([_to(x, lead) for x in payloads], dim=1)
    gidx = torch.cat([_to(x, lead) for x in gidx], dim=1)   # (B, k·P)
    COLLECTIVES["gather_candidates"] += 1
    est, r_lo, r_up = payload[..., 0], payload[..., 1], payload[..., 2]
    sel, guaranteed, accepted, pruned = lemma1_select(
        r_lo, r_up, est, R_lo_k=R[0], R_up_k=R[1], k=k, c=c,
        m_items=m_items)
    return QueryResult(
        indices=torch.gather(gidx, -1, sel),
        est_rank=torch.gather(est, -1, sel),
        r_lo=r_lo, r_up=r_up,           # candidate-set bounds (B, k·P)
        R_lo_k=R[0], R_up_k=R[1], guaranteed=guaranteed,
        n_accepted=accepted.sum(dim=-1, dtype=torch.int32),
        n_pruned=pruned.sum(dim=-1, dtype=torch.int32))


def shard_bounds(mesh: tuple, rt: RankTable, users, qs: torch.Tensor,
                 corr: Optional[DeltaCorrection] = None):
    """Each shard's own (r_lo, r_up, est), concatenated in shard order on
    the lead → (B, n) each: what the tree merge selects over (a check
    surface; the query never forms it)."""
    mesh = flat_mesh(mesh)
    rts, us, cs = split_state(rt, users, corr, mesh)
    parts = []
    for dev, rt_s, u_s, c_s in zip(mesh, rts, us, cs):
        with _on(dev):
            parts.append(_local_bounds(rt_s, u_s, _to(qs, dev), c_s))
    return tuple(torch.cat([_to(p[i], mesh[0]) for p in parts], dim=-1)
                 for i in range(3))


def make_batch_query_fn(mesh, k: int, n: int, c: float, *,
                        with_delta: bool = False):
    """The batched sharded query: `fn(rank_table, users, qs (B, d)
    [, corr])` → QueryResult with a leading B axis.

    Step 1 on each shard is one (n/P, d) × (d, B) product and one pass
    over the shard's table rows for all B queries; with `with_delta` the
    shard's correction rows are applied before the shard's top-k
    (correcting after the candidate selection would pick the wrong
    candidates). Then the tree merge (`_tree_merge`). The result's r↓/r↑
    are the (B, k·P) candidate-set bounds and n_accepted / n_pruned count
    over the candidates, as in the reference."""
    mesh = flat_mesh(mesh)
    shard_n = _need_even(n, len(mesh), "sharded query")

    def batch_query_fn(rt: RankTable, users, qs: torch.Tensor,
                       corr: Optional[DeltaCorrection] = None
                       ) -> QueryResult:
        if (corr is not None) != with_delta:
            raise ValueError(f"this query function was built with "
                             f"with_delta={with_delta}")
        if users.shape[0] != n:
            raise ValueError(f"built for n={n}, got {users.shape[0]} users")
        rts, us, cs = split_state(rt, users, corr, mesh)
        bounds, rows = [], []
        for s, (dev, rt_s, u_s, c_s) in enumerate(zip(mesh, rts, us, cs)):
            with _on(dev):
                bounds.append(_local_bounds(rt_s, u_s, _to(qs, dev), c_s))
                rows.append(torch.arange(s * shard_n, (s + 1) * shard_n,
                                         device=dev))
        return _tree_merge(mesh, bounds, rows, k=k, c=c,
                           m_items=corr.selection_m() if with_delta
                           else rt.m)

    return batch_query_fn


def make_pruned_batch_query_fn(mesh, k: int, n: int, c: float, *,
                               block_size: int, with_delta: bool = False):
    """The block-pruned twin of `make_batch_query_fn`: each shard gathers
    only its kept user tiles before its top-k; the merge is unchanged.

    The returned fn takes, after (rank_table, users, qs):
      ids   (P, W) int on the host: each shard's LOCAL block ids, every
            shard padded to one width W by repeating its kept ids;
      valid (P, W) bool on the host: False on the repeats (and on a
            shard with nothing kept), whose rows read +inf, so that a row
            is never a candidate twice;
      keep  (B, nb) bool: each query's phase-A keep mask over GLOBAL block
            ids; a row executed only for another query reads +inf.
    then the correction with `with_delta`. Needs n % (P·block_size) == 0
    (a tile must not straddle shards; `PrunedBackend` falls back to the
    full scan otherwise). A cluster reorder is a global permutation
    applied before sharding, so nothing here changes for it."""
    mesh = flat_mesh(mesh)
    P = len(mesh)
    if n % (P * block_size):
        raise ValueError(f"pruned sharded query needs n % (P·block_size) "
                         f"== 0; got n={n}, P={P}, block_size={block_size}")
    shard_n = n // P
    nb_loc = shard_n // block_size

    def batch_query_fn(rt: RankTable, users, qs: torch.Tensor, ids, valid,
                       keep: torch.Tensor,
                       corr: Optional[DeltaCorrection] = None
                       ) -> QueryResult:
        if (corr is not None) != with_delta:
            raise ValueError(f"this query function was built with "
                             f"with_delta={with_delta}")
        if users.shape[0] != n:
            raise ValueError(f"built for n={n}, got {users.shape[0]} users")
        # one upload to the lead from pinned memory (a copy from pageable
        # memory would wait on the stream), then device-to-device copies
        lead = mesh[0]
        ids, valid = (torch.as_tensor(np.asarray(x, t)) for x, t in
                      ((ids, np.int64), (valid, bool)))
        if lead.type == "cuda":
            ids, valid = (x.pin_memory().to(lead, non_blocking=True)
                          for x in (ids, valid))
        rts, us, cs = split_state(rt, users, corr, mesh)
        bounds, rows = [], []
        for s, (dev, rt_s, u_s, c_s) in enumerate(zip(mesh, rts, us, cs)):
            with _on(dev):
                ids_s, valid_s = _to(ids[s], dev), _to(valid[s], dev)
                ridx = (ids_s[:, None] * block_size + torch.arange(
                    block_size, device=dev)[None, :]).reshape(-1)
                r_lo, r_up, est = _local_bounds(
                    rt_s.take_rows(ridx), take_user_rows(u_s, ridx),
                    _to(qs, dev),
                    None if c_s is None else c_s.take_rows(ridx))
                keep_rows = _to(keep, dev)[:, s * nb_loc + ids_s] \
                    & valid_s[None, :]                      # (B, W)
                alive = keep_rows.repeat_interleave(block_size, dim=1)
                bounds.append(tuple(torch.where(alive, x, torch.inf)
                                    for x in (r_lo, r_up, est)))
                rows.append(ridx + s * shard_n)
        return _tree_merge(mesh, bounds, rows, k=k, c=c,
                           m_items=corr.selection_m() if with_delta
                           else rt.m)

    return batch_query_fn


def make_query_fn(mesh, k: int, n: int, c: float):
    """One query: the B = 1 case of `make_batch_query_fn` (the same
    merge), leading axis squeezed."""
    batched = make_batch_query_fn(mesh, k=k, n=n, c=c)

    def query_fn(rt: RankTable, users, q: torch.Tensor) -> QueryResult:
        return squeeze_result(batched(rt, users, q[None, :]))

    return query_fn


# -------------------------------------------------------------- refinement
def ring_exact_ranks(users: torch.Tensor, items: torch.Tensor,
                     q: torch.Tensor, mesh) -> torch.Tensor:
    """Definition-1 ranks with users AND items split over the mesh: the
    item blocks rotate around the shards (block j moves to shard j + 1
    each step) while every user shard adds up its counts, so items never
    gather whole. Each (user shard, item block) count is
    `ops.exact_ranks(u, block, q) - 1`: K3 on the card, which computes
    u·q by the same loop in every call, so the counts add exactly and the
    result is the ranks over all items. → (n,) f32 on the lead, as in the
    reference."""
    mesh = flat_mesh(mesh)
    P = len(mesh)
    u_parts = [u.contiguous() for u in shard_rows(users, mesh)]
    blocks = [b.contiguous() for b in shard_rows(items, mesh)]
    qs = [_to(q, dev).contiguous() for dev in mesh]
    counts = [None] * P
    for step in range(P):
        for s, dev in enumerate(mesh):
            with _on(dev):
                part = ops.exact_ranks(u_parts[s], blocks[s], qs[s]) - 1
                counts[s] = part if counts[s] is None else counts[s] + part
        if step + 1 < P:                # shard s takes shard s-1's block
            blocks = [_to(blocks[(s - 1) % P], dev)
                      for s, dev in enumerate(mesh)]
    return torch.cat([_to(1 + x, mesh[0]) for x in counts]).to(
        torch.float32)
