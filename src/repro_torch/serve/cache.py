"""Caching query backend: within-tick dedupe + cross-tick LRU reuse (a
port of `repro/serve/cache.py`).

Reverse-MIPS serving workloads are dominated by HOT queries — the same
promoted items get asked about again and again (Amagata & Hara,
arXiv:2110.07131) — and the micro-batching scheduler makes duplicates
even more likely by packing temporally-close requests into one tick.
`CachingBackend` wraps ANY registered inner backend and exploits both:

  * within a tick, exact-duplicate query rows (same bytes, same k/c) are
    deduped BEFORE dispatch — the inner backend sees one column per
    distinct query (the scheduler's pad rows collapse for free, since
    edge padding repeats a real query);
  * across ticks, per-query `QueryResult`s are kept in an LRU keyed by
    (query bytes, k, c), so a hot query is answered without touching the
    rank table at all.

Resolved from the registry as `"cached:<inner>"`::

    eng = ReverseKRanksEngine.build(..., backend="cached:fused")
    eng.query_batch(qs, k=10, c=2.0)        # dedupes + caches

Bit-identity contract (tests/test_torch_serve.py): cached, deduped, and
full uncached dispatch agree BITWISE. The step-1 kernels compute each
query's column with the same operations at every batch width; a plain
matmul's column depends only on the user matrix, that query column and
the accumulation order, which may change for a width-1 product (a
matrix-vector kernel), so the miss block is padded to width 2 whenever
dedupe would shrink a multi-query tick to a single column
(`_MIN_DISPATCH`); a true B = 1 call dispatches width 1 and matches
uncached B = 1 execution exactly.

The cache is invalidated whenever the (rank_table, users, delta) identity
it was filled under changes — for the epoch-versioned mutable engine
(`repro_torch.index`) that is exactly a snapshot-generation change, so
a mutation or rebuild hot-swap never serves a stale-epoch entry.
Results are cached per (k, c) — the selection is a function of both —
and the wrapped result keeps the inner backend's QueryResult shape.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core import backends as BK
from repro_torch.core.types import QueryResult, RankTable, StoredUsers
from repro_torch.obs import registry as obs
from repro_torch.obs import trace

# Never let dedupe shrink a multi-query dispatch to one column: a width-1
# product may take another accumulation order, which would break the
# bitwise cached == uncached contract (module docstring).
_MIN_DISPATCH = 2


def _host_rows(qs) -> np.ndarray:
    """A query row or block as host numpy (a copy to the host for a
    device tensor)."""
    if isinstance(qs, torch.Tensor):
        return qs.detach().cpu().numpy()
    return np.asarray(qs)


def _canonical_key_row(row: np.ndarray) -> np.ndarray:
    """One bit pattern per semantically-equal query row, for cache keying.

    `row + 0.0` maps −0.0 → +0.0 (IEEE 754 addition; every other value,
    including NaN and ±inf, is returned unchanged in VALUE) and gives a
    fresh array we may edit; any NaN coordinate is then rewritten to the
    single canonical qNaN pattern, collapsing payload/sign variants.
    Scoring is payload-blind (x·NaN is NaN for every payload), so rows
    differing only in these bits get identical QueryResults and must get
    identical keys.
    """
    out = row + row.dtype.type(0.0)
    nan = np.isnan(out)
    if nan.any():
        out[nan] = row.dtype.type(np.nan)
    return out


class CachingBackend(BK.QueryBackend):
    """Wrap an inner QueryBackend with dedupe + per-query LRU caching.

    `capacity` is in ENTRIES, and an entry is a full per-query
    QueryResult, which includes the (n,) r↓/r↑ bound vectors, ≈ 8n bytes
    each. Size it from the per-entry cost: the default 512 is ~80 MiB at
    n = 20k, and about 2 GB at the Netflix size (n = 480,189).

    NEAR-DUPLICATE caching (opt-in): `quantize_key_bits = b` keys
    the LRU on the QUANTIZED query bytes instead of the exact bytes —
    each coordinate is snapped to a 2^(b−1)-level grid under a
    power-of-two per-query scale (the storage tier's quantizer, applied
    to the key only). Queries within roughly half a grid step per
    coordinate then SHARE an entry: a hot item's jittered re-asks become
    hits at a bounded quality cost (the served result is the exact
    answer of a query within the cell — the rank perturbation is the
    same order as the c-approximation slack for small cells). The
    default None keeps the exact-byte contract (bitwise cached ==
    uncached); with quantization enabled the bit-identity contract
    deliberately WEAKENS to per-cell identity — measure the
    hit-rate/overall-ratio tradeoff.
    """

    def __init__(self, inner="dense", *, capacity: int = 512,
                 quantize_key_bits: Optional[int] = None):
        self.inner = BK.get_backend(inner)
        self.name = f"cached:{self.inner.name}"
        self.capacity = int(capacity)
        if quantize_key_bits is not None and not (
                2 <= int(quantize_key_bits) <= 15):
            raise ValueError("quantize_key_bits must be in [2, 15] "
                             f"(int16 grid); got {quantize_key_bits}")
        self.quantize_key_bits = (None if quantize_key_bits is None
                                  else int(quantize_key_bits))
        self._lru: "OrderedDict[tuple, QueryResult]" = OrderedDict()
        self._epoch: Optional[tuple] = None
        # LRU/epoch state is touched from the scheduler's dispatcher
        # thread AND from client threads probing on the
        # admission path (`MicroBatcher.submit` → `lookup_only`) — an
        # RLock because `query_batch`'s guarded insert loop calls the
        # guarded `_insert`.
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Registry mirrors of the instance counters (shared across every
        # CachingBackend in the process — a fleet dashboard wants totals,
        # the per-instance attributes stay the fine-grained surface).
        reg = obs.get_default()
        self._m_hits = reg.counter("cache_hits_total", "LRU lookup hits")
        self._m_misses = reg.counter("cache_misses_total",
                                     "LRU lookup misses")
        self._m_evictions = reg.counter("cache_evictions_total",
                                        "entries evicted at capacity")
        self._m_size = reg.gauge("cache_entries",
                                 "live entries in the LRU")

    def _key_bytes(self, row: np.ndarray) -> bytes:
        # Canonicalize BEFORE keying on raw bytes: f32 has distinct bit
        # patterns for semantically identical queries (−0.0 vs +0.0, and
        # 2^24−2 NaN payloads — any NaN coordinate makes every score NaN,
        # so all-NaN-payload queries produce the same answer). Keying the
        # raw pattern made such re-asks LRU misses; with quantization the
        # −0.0 case additionally slipped through np.round (round(−0.0·s)
        # = −0.0 → int16 0 on every path EXCEPT the amax==0/non-finite
        # raw-bytes fallbacks, which re-exposed the raw pattern).
        row = _canonical_key_row(row)
        if self.quantize_key_bits is None:
            return row.tobytes()
        amax = float(np.max(np.abs(row)))
        if amax == 0.0 or not np.isfinite(amax):
            return row.tobytes()
        # power-of-two scale bucket: near-duplicates keep the same
        # exponent except at bucket edges (a bounded miss source)
        exp = int(np.ceil(np.log2(amax)))
        levels = float(2 ** (self.quantize_key_bits - 1) - 1)
        q = np.round(row * (levels / 2.0 ** exp)).astype(np.int16)
        return q.tobytes() + exp.to_bytes(2, "little", signed=True)

    # ----------------------------------------------------------- plumbing
    def bound_ranks(self, rt, users, qs):
        """Step 1 is delegated uncached — bounds are an internal debugging
        surface; caching applies to the end-to-end per-query result."""
        return self.inner.bound_ranks(rt, users, qs)

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._epoch = None

    def build_index(self, users, items, cfg, generator=None, *,
                    positions=None, weights=None):
        """Builds run on the wrapped backend's substrate."""
        return self.inner.build_index(users, items, cfg, generator,
                                      positions=positions, weights=weights)

    def degrade(self, level):
        """Ladder levels act on the wrapped execution backend."""
        self.inner.degrade(level)

    def _check_epoch(self, rt: RankTable, users, delta=None) -> None:
        """Cached results are only valid for the index GENERATION they
        were computed against; key the cache generation on the array
        identities — rank table, users, AND the delta-correction arrays
        (a mutation that only changes the delta buffer changes every
        result too). Snapshot generations are immutable
        (`repro_torch.index`),
        so identity equality is exactly epoch equality: any hot-swap or
        mutation drops every stale-epoch entry before the next lookup.
        Identities are held as WEAK references — a bare id() could be
        recycled by a rebuilt index landing at the same address, silently
        serving stale results, while strong references would pin the old
        table in memory."""
        if isinstance(users, StoredUsers):
            users = users.rows          # tuples aren't weakref'able; the
        arrays = (rt.thresholds, rt.table, users)   # rows array is 1:1
        if delta is not None:
            arrays += (delta.add_scores, delta.del_scores, delta.user_live)
        if (self._epoch is None or len(self._epoch) != len(arrays)
                or any(ref() is not a
                       for ref, a in zip(self._epoch, arrays))):
            self._lru.clear()
            self._epoch = tuple(weakref.ref(a) for a in arrays)

    def _insert(self, key: tuple, res: QueryResult) -> None:
        with self._lock:
            self._lru[key] = res
            self._lru.move_to_end(key)
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)
                self.evictions += 1
                self._m_evictions.inc()
            self._m_size.set(len(self._lru))

    def lookup_only(self, rt, users, row, *, k, c, delta=None,
                    record_miss: bool = True):
        """LRU probe WITHOUT dispatch: the cached per-query QueryResult
        if this exact (query, k, c) is live for the CURRENT index
        generation, else None. Never touches the inner backend. Two
        callers (repro_torch.serve): the cache-only degrade rung 3, and
        the scheduler's ADMISSION path (a hit resolves at submit and
        never occupies a tick slot). The admission path passes
        `record_miss=False`: its misses go on to dispatch through
        `query_batch`, which counts them — double-counting would skew the
        hit-rate dashboards."""
        with self._lock:
            self._check_epoch(rt, users, delta)
            key = (self._key_bytes(_host_rows(row)), int(k), float(c))
            cached = self._lru.get(key)
            if cached is None:
                if record_miss:
                    self.misses += 1
                    self._m_misses.inc()
                return None
            self._lru.move_to_end(key)
            self.hits += 1
        self._m_hits.inc()
        return cached

    # -------------------------------------------------------------- query
    def _lookup_batch(self, rt, users, rows, *, k, c, delta):
        """Shared lookup phase over HOST query rows: per-row LRU probe
        under the lock. Returns (keys, per_query, miss_order) — the
        dispatch entries (`query_batch`, `dispatch_device`) execute the
        deduped miss block their own way and hand the result to
        `_finish_batch`."""
        with trace.span("cache.lookup", batch=rows.shape[0]) as sp:
            with self._lock:
                self._check_epoch(rt, users, delta)
                keys = [(self._key_bytes(rows[i]), int(k), float(c))
                        for i in range(rows.shape[0])]

                per_query: list = [None] * len(keys)
                miss_order: "OrderedDict[tuple, int]" = OrderedDict()
                for i, key in enumerate(keys):
                    cached = self._lru.get(key)
                    if cached is not None:
                        self._lru.move_to_end(key)
                        per_query[i] = cached
                        self.hits += 1
                    else:
                        miss_order.setdefault(key, i)  # dedupe: first seen
                        self.misses += 1
            n_miss = len(keys) - sum(r is not None for r in per_query)
            sp.set(hits=len(keys) - n_miss, misses=n_miss)
        self._m_hits.inc(len(keys) - n_miss)
        self._m_misses.inc(n_miss)
        return keys, per_query, miss_order

    def _finish_batch(self, keys, per_query, miss_order, res):
        """Insert the miss block's per-query slices and assemble the
        tick's stacked QueryResult (tick-local results survive assembly
        even when the LRU is smaller than the tick's own unique-miss
        count)."""
        if miss_order:
            fresh = {}
            for j, key in enumerate(miss_order):
                one = QueryResult(*(x[j] for x in res))
                fresh[key] = one
                self._insert(key, one)
            for i, key in enumerate(keys):
                if per_query[i] is None:
                    per_query[i] = fresh[key]
        return QueryResult(*(torch.stack(xs) for xs in zip(*per_query)))

    def query_batch(self, rt, users, qs, *, k, c, delta=None):
        rows = _host_rows(qs)
        keys, per_query, miss_order = self._lookup_batch(
            rt, users, rows, k=k, c=c, delta=delta)
        res = None
        if miss_order:
            idx = list(miss_order.values())
            block = qs[torch.tensor(idx, device=qs.device)]
            if len(idx) < _MIN_DISPATCH <= len(keys):
                block = torch.cat([block, block[-1:]])
            # omit the delta kwarg on the static path (as
            # engine.query_batch_at does)
            if delta is None:
                res = self.inner.query_batch(rt, users, block, k=k, c=c)
            else:
                res = self.inner.query_batch(rt, users, block, k=k, c=c,
                                             delta=delta)
        return self._finish_batch(keys, per_query, miss_order, res)

    def dispatch_device(self, rt, users, qs, *, k, c, delta=None):
        """Serving entry: HOST query rows in, device tensors out. Keying
        needs host bytes, which the scheduler keeps, so the lookup pays no
        transfer; only the deduped MISS block is gathered on the host and
        staged by the inner `dispatch_device`'s one copy. Hits are cached
        per-query device results, so the assembled stack is device
        tensors either way, with no host sync on this path. Values are
        bitwise `query_batch`'s (same miss block bytes, same inner
        computation)."""
        rows = _host_rows(qs)
        keys, per_query, miss_order = self._lookup_batch(
            rt, users, rows, k=k, c=c, delta=delta)
        res = None
        if miss_order:
            idx = list(miss_order.values())
            block = rows[idx]
            if len(idx) < _MIN_DISPATCH <= len(keys):
                block = np.concatenate([block, block[-1:]])
            res = self.inner.dispatch_device(rt, users, block, k=k, c=c,
                                             delta=delta)
        return self._finish_batch(keys, per_query, miss_order, res)


@BK.register_wrapper("cached")
def _make_cached(inner: str) -> CachingBackend:
    """Registry hook: `get_backend("cached:<inner>")` lands here."""
    return CachingBackend(inner)
