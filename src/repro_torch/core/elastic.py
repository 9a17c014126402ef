"""Compile-once elastic serving: one program per capacity bucket, never
per n.

Counterpart of `repro/core/elastic.py`. Every other backend's query is
shaped by n, the user count, so growing n (appends, a rebuild) changes
every shape of the query. This wrapper pads the operands (users, rank
table, delta correction) to a power-of-two capacity
`capacity_for(n, tile)` and runs one program per

    (tile, d, B, τ, storage spec, k, capacity; for the fused inner the
     table's m; on a mutated index the delta's padded widths)

in which the valid row count n is a runtime value. On the card the
program is captured into a CUDA graph the first time it runs and
replayed after that; on the CPU it runs eagerly, but is still built once
per key, so `elastic_trace_count()` means the same on both devices.

The program:

  1. step 1 over the capacity: for the fused inner one call of
     `kernels.ops.bound_ranks_batched_stored` with `n_valid` (K1, K4 or
     K5's elastic entry,
     which reads n on the device and scores only the first ⌈n / T⌉
     tiles, the counterpart of the TPU tile loop `ops.bound_ranks_tile`
     under a `fori_loop` with a data-dependent trip count); for the dense
     inner the plain bounds of the padded operands; on a mutated index
     then the shared `rank_table.apply_delta_corrections`;
  2. rows at or past n are set to a dominated SENTINEL, +inf on both
     paths. The reference takes +inf on the delta path and m + 2 on the
     static one, which dominates every real value only while every real
     bound and estimate is at most m + 1. That holds at f32, but not on a
     quantized table: a bf16 r↑ reaches (m + 1)(1 + 2⁻⁸)² (the rounded
     table value, widened), an int8 r↑ half a code step past m + 1, and
     est follows r↑; with k near n the pads then entered the top-k (a
     bf16 query at k = n selected pad rows). +inf fails every accept
     test, passes every prune test and sorts after every finite key, so
     for k ≤ n the order statistics, the indices and their tie-breaks
     are those of the n real rows at every spec (the tests hold this
     bitwise against the inner backends);
  3. `query.select_topk` over the (B, capacity) bounds;
  4. the two Lemma-1 counters, which do see the pads, are corrected by
     pad·[S ≤ c·R↓_k] and pad·[S > R↑_k] (as the reference does; the
     corrected counts are those of the real rows whatever S is).

Everything the program reads besides its padded operands lives in device
tensors written before each run: the query block, n (one int32), c, the
static path's m, and on the delta path m' and the selection offset
`selection_m()`. So an n sweep inside a bucket, a change of c, item
churn on the delta path and a rebuild that grows n inside the bucket all
reuse the captured graph. (The fused kernels take m + 1 as an argument,
so the fused inner keys its program on the table's m, as the reference
keys its Pallas call.)

Padding happens on the device. The padded operands of a bucket are the
programs' static input buffers: a new index generation copies rows
[0, n) into them and writes the pad values only where rows stopped being
valid (`elastic_repads_total` counts each repad), stream-ordered after
the runs already queued. Pad rows follow the kernels' padding
conventions: user rows 0 with unit scale and zero slack (every score
exactly 0), thresholds 0, table 1.0 (int8 code 0), scales 1.0, offsets
and dev 0.0; on the delta path pad rows are DEAD users (user_live False)
with absent score sets (−inf; −128 at int8), so the correction stays
finite on them.

A captured graph writes its outputs into the same memory at every
replay, so `query_batch` and `dispatch_device` copy the outputs out on
the stream before returning: a result the caller holds owns its memory.
The copies restore the documented (B, n) shape of r_lo and r_up.

Usage (a wrapper backend, composed by name)::

    eng = ReverseKRanksEngine.build(..., backend="elastic:fused")
    eng = ReverseKRanksEngine.build(..., backend="elastic:dense")

Stock dense and fused inners get the program ("elastic:" is
"elastic:dense"). Any other inner (pruned, whose keep lists are read on
the host, or a subclass that overrides `bound_ranks` or `select`)
delegates unchanged, as the reference documents, and so does k > n.

The tile is `REPRO_ELASTIC_TILE` (default 256, a positive multiple of 32,
validated as in the reference). It sets the capacity buckets; the
kernels' own tile of rows is theirs.
"""
from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Optional

import torch

from repro_torch.core import backends as BK
from repro_torch.core import query as query_mod
from repro_torch.core import rank_table as rt_mod
from repro_torch.core.types import DeltaCorrection, QueryResult, \
    RankTable, StoredUsers, stored_rows
from repro_torch.kernels import ops
from repro_torch.obs import registry as obs
from repro_torch.obs import trace

# Elastic programs constructed in this process: one per key, on either
# device, so an n sweep inside one capacity bucket leaves it unchanged.
_PROGRAMS_BUILT = 0


def default_tile() -> int:
    """The elastic tile: `REPRO_ELASTIC_TILE` (default 256), a positive
    multiple of 32 as the reference requires."""
    raw = os.environ.get("REPRO_ELASTIC_TILE", "").strip()
    tile = int(raw) if raw else 256
    if tile < 32 or tile % 32:
        raise ValueError(
            f"REPRO_ELASTIC_TILE must be a positive multiple of 32 "
            f"(TPU min-tile alignment for f32/bf16/int8); got {tile}")
    return tile


def capacity_for(n: int, tile: int) -> int:
    """Row capacity serving n users: tile · next_pow2(⌈n/tile⌉). Every n
    in (cap/2, cap] shares one bucket, so a lifetime of growth builds
    O(log n) programs."""
    n_tiles = max(1, -(-int(n) // tile))
    return tile * (1 << (n_tiles - 1).bit_length())


# --------------------------------------------------------------- padding
def _pad_rows(x: Optional[torch.Tensor], cap: int, value):
    """`x` padded to `cap` rows with `value`, on its device (None stays
    None)."""
    if x is None:
        return None
    out = torch.full((cap,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                     device=x.device)
    out[: x.shape[0]].copy_(x)
    return out


def _user_fields(users) -> dict:
    """name → (tensor, pad value) of either user representation: pad rows
    are all zero with unit scale and zero slack, so their scores are
    exactly 0 and every lookup on them is finite."""
    if isinstance(users, StoredUsers):
        return {"rows": (users.rows, 0), "scale": (users.scale, 1.0),
                "row_slack": (users.row_slack, 0.0)}
    return {"rows": (users, 0.0)}


_TABLE_PAD = {"thr_scale": 1.0, "thr_off": 0.0, "tab_scale": 1.0,
              "tab_off": 0.0, "thr_dev": 0.0}


def _table_fields(rt: RankTable) -> dict:
    """name → (tensor, pad value) of every row-aligned table field:
    thresholds 0 (a constant, ascending row), table 1.0 (int8: code 0),
    scales 1.0, offsets and dev 0.0."""
    tab_pad = 0 if rt.table.dtype == torch.int8 else 1.0
    out = {"thresholds": (rt.thresholds, 0), "table": (rt.table, tab_pad)}
    out.update({f: (getattr(rt, f), _TABLE_PAD[f])
                for f in RankTable._QUANT_FIELDS})
    return out


def _absent(t: Optional[torch.Tensor]):
    return -128 if t is not None and t.dtype == torch.int8 else -torch.inf


def _corr_fields(corr: DeltaCorrection) -> dict:
    """name → (tensor, pad value) of the delta correction: pad rows are
    dead users with absent score sets, scales 1.0 and offsets 0.0."""
    return {"add_scores": (corr.add_scores, _absent(corr.add_scores)),
            "del_scores": (corr.del_scores, _absent(corr.del_scores)),
            "user_live": (corr.user_live, False),
            "add_scale": (corr.add_scale, 1.0),
            "add_off": (corr.add_off, 0.0),
            "del_scale": (corr.del_scale, 1.0),
            "del_off": (corr.del_off, 0.0)}


def _pad_users(users, cap: int):
    """Capacity-pad either user representation (`_user_fields`)."""
    f = {k: _pad_rows(t, cap, v) for k, (t, v) in _user_fields(users).items()}
    return StoredUsers(**f) if isinstance(users, StoredUsers) else f["rows"]


def _pad_table(rt: RankTable, cap: int) -> RankTable:
    """Capacity-pad every row-aligned rank-table field (`_table_fields`)."""
    return RankTable(m=rt.m, **{k: _pad_rows(t, cap, v) for k, (t, v)
                                in _table_fields(rt).items()})


def _pad_corr(corr: DeltaCorrection, cap: int) -> DeltaCorrection:
    """Capacity-pad the delta correction (`_corr_fields`)."""
    return DeltaCorrection(m_new=corr.m_new, **{
        k: _pad_rows(t, cap, v) for k, (t, v) in _corr_fields(corr).items()})


class _Bucket:
    """The padded operands of one capacity bucket: the static input
    buffers of every program keyed on it. `refill` copies a new
    generation's rows [0, n) in place and resets rows that stopped being
    valid to their pad values, so a graph captured over these buffers
    stays valid across generations. It remembers its generation by weak
    references, so it never keeps an old generation alive."""

    def __init__(self, rt: RankTable, users, corr: Optional[DeltaCorrection],
                 cap: int):
        self.cap = cap
        self.users = _pad_users(users, cap)
        self.rt = _pad_table(rt, cap)
        self.corr = None if corr is None else _pad_corr(corr, cap)
        self.filled = users.shape[0]
        self._gen = self._refs(rt, users, corr)

    @staticmethod
    def _sources(rt, users, corr) -> tuple:
        srcs = (stored_rows(users), rt.thresholds, rt.table)
        if corr is not None:
            srcs += (corr.add_scores, corr.del_scores, corr.user_live)
        return srcs

    def _refs(self, rt, users, corr) -> tuple:
        return tuple(weakref.ref(a) for a in self._sources(rt, users, corr))

    def holds(self, rt, users, corr) -> bool:
        srcs = self._sources(rt, users, corr)
        return len(srcs) == len(self._gen) and all(
            r() is a for r, a in zip(self._gen, srcs))

    def _pairs(self, rt, users, corr):
        """(padded buffer, new rows, pad value) of every field."""
        pads = [(_user_fields(self.users), _user_fields(users)),
                (_table_fields(self.rt), _table_fields(rt))]
        if corr is not None:
            pads.append((_corr_fields(self.corr), _corr_fields(corr)))
        for mine, new in pads:
            for name, (buf, value) in mine.items():
                if buf is not None:
                    yield buf, new[name][0], value

    def refill(self, rt, users, corr) -> None:
        n = users.shape[0]
        for buf, src, value in self._pairs(rt, users, corr):
            buf[:n].copy_(src)
            if n < self.filled:
                buf[n:self.filled].fill_(value)
        self.filled = n
        self._gen = self._refs(rt, users, corr)


def _bucket_key(rt: RankTable, users, corr, cap: int) -> tuple:
    """Capacity and the dtype and row shape of every padded field."""
    fields = {**_user_fields(users), **_table_fields(rt)}
    if corr is not None:
        fields.update(_corr_fields(corr))
    return (cap, stored_rows(users).device) + tuple(
        (name, None if t is None else (t.dtype, tuple(t.shape[1:])))
        for name, (t, _) in sorted(fields.items()))


# ------------------------------------------------------------ the program
class _Program:
    """One elastic program: static inputs (the query block, n, c, m and
    on the delta path m' and the selection offset, all device tensors),
    the bucket's padded operands, and the body of module doc steps 1-4.
    On CUDA the body is captured into a CUDA graph at its first run
    (after one eager run on a side stream, which loads the kernels'
    modules and the library handles) and replayed after that; a capture
    that fails raises. On the CPU the body runs eagerly."""

    def __init__(self, bucket: _Bucket, B: int, d: int, k: int,
                 fused: bool, m_kernel: Optional[int]):
        global _PROGRAMS_BUILT
        _PROGRAMS_BUILT += 1
        dev = bucket.users.rows.device if isinstance(
            bucket.users, StoredUsers) else bucket.users.device
        self.bucket, self.k, self.fused = bucket, k, fused
        self.m_kernel = m_kernel
        f32 = dict(dtype=torch.float32, device=dev)
        self.qs = torch.zeros((B, d), **f32)
        self.n_valid = torch.zeros(1, dtype=torch.int32, device=dev)
        self.c = torch.zeros((), **f32)
        self.m = torch.zeros((), **f32)
        self.m_new = torch.zeros((), **f32)
        self.sel_m = torch.zeros((), **f32)
        self.rows = torch.arange(bucket.cap, dtype=torch.int32, device=dev)
        self.graph = None
        self.out: Optional[QueryResult] = None
        self.recorded: dict = {}    # kernel launches the graph holds
        self.replays = 0

    def _body(self) -> QueryResult:
        b = self.bucket
        users, qs = b.users, self.qs
        corr = None if b.corr is None else b.corr._replace(m_new=self.m_new)
        if self.fused:
            rt_k = b.rt._replace(m=self.m_kernel)
            r_lo, r_up, est = ops.bound_ranks_batched_stored(
                users, qs, rt_k, self.n_valid)
            if corr is not None:
                scores, slack = query_mod.user_scores_batch(users, qs)
                r_lo, r_up, est = rt_mod.apply_delta_corrections(
                    scores, r_lo.T, r_up.T, est.T, corr, slack=slack)
                r_lo, r_up, est = r_lo.T, r_up.T, est.T
        else:
            rt_d = b.rt._replace(m=self.m)
            if corr is None:
                r_lo, r_up, est = query_mod.bound_ranks_batch(rt_d, users, qs)
            else:
                r_lo, r_up, est = query_mod._delta_bounds_batch(
                    rt_d, users, qs, corr)
        sentinel = torch.inf                                # module doc
        live = self.rows < self.n_valid                     # (cap,)
        r_lo = torch.where(live, r_lo, sentinel)
        r_up = torch.where(live, r_up, sentinel)
        est = torch.where(live, est, sentinel)
        m_items = self.sel_m if corr is not None else self.m
        res = query_mod.select_topk(r_lo, r_up, est, k=self.k, c=self.c,
                                    m_items=m_items)
        # the two Lemma-1 counters are the only fields that see the pads
        pad = b.cap - self.n_valid                          # (1,) int32
        over_acc = pad * (sentinel <= self.c * res.R_lo_k).to(torch.int32)
        over_prn = pad * (sentinel > res.R_up_k).to(torch.int32)
        return res._replace(n_accepted=res.n_accepted - over_acc,
                            n_pruned=res.n_pruned - over_prn)

    def _capture(self) -> None:
        dev = self.qs.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(ops.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._body()
        # what the capture put into the graph: each replay runs these
        # launches without a wrapper call, so none of them is counted
        self.recorded = {k: v - before[k] for k, v in ops.LAUNCHES.items()
                         if v != before[k]}
        self.graph, self.out = graph, out

    def run(self, qs: torch.Tensor, n: int, c: float, m: int,
            corr: Optional[DeltaCorrection]) -> QueryResult:
        """Write the static inputs, run (or replay) the body, and copy
        its outputs out: (B, n) r_lo/r_up, every field owning its
        memory."""
        self.qs.copy_(qs, non_blocking=True)
        self.n_valid.fill_(n)
        self.c.fill_(float(c))
        self.m.fill_(float(m))
        if corr is not None:
            self.m_new.fill_(float(corr.m_new))
            self.sel_m.fill_(float(corr.selection_m()))
        if self.qs.device.type != "cuda":
            out = self._body()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.replays += 1
            out = self.out
        return QueryResult(*(x[:, :n].clone() if x.dim() == 2
                             and name in ("r_lo", "r_up") else x.clone()
                             for name, x in zip(QueryResult._fields, out)))


# -------------------------------------------------------- observability
def elastic_trace_count() -> int:
    """Elastic programs constructed so far (monotone; one per key ever
    served, the key never holding n)."""
    return _PROGRAMS_BUILT


def compiled_program_count() -> int:
    """Programs built across the port's query stack: the elastic
    programs (each a CUDA graph on the card; eager PyTorch compiles
    nothing else). The scheduler samples it around every tick
    (`TickStats.compiles`); the `query_compiled_programs` gauge reads it
    at scrape time."""
    return _PROGRAMS_BUILT


obs.get_default().gauge(
    "query_compiled_programs",
    "elastic programs built (CUDA graphs on the card)"
).set_function(compiled_program_count)


# ------------------------------------------------------------ the backend
class ElasticBackend(BK.QueryBackend):
    """Wrapper backend: one program per capacity bucket over a stock
    dense or fused inner; any other inner delegates unchanged (module
    doc).

    Calls serialize on a lock (the buckets and programs are shared
    static buffers), and each call's stream waits on the previous call's
    end, so two threads on two streams never interleave a refill with a
    replay. Padded buckets are kept for the last `_BUCKETS` keys; a
    program whose bucket is dropped is dropped with it.
    """

    _BUCKETS = 2

    def __init__(self, inner="dense", *, tile: Optional[int] = None,
                 mesh=None):
        super().__init__(mesh=mesh)
        self.inner = BK.get_backend(inner or "dense", mesh=mesh)
        self.name = f"elastic:{self.inner.name}"
        self.tile = int(tile) if tile else default_tile()
        if self.tile < 32 or self.tile % 32:
            raise ValueError(f"elastic tile must be a positive multiple "
                             f"of 32; got {self.tile}")
        if (type(self.inner) is BK.DenseBackend
                and BK._stock_pipeline(self.inner, BK.DenseBackend)):
            self._mode = "dense"
        elif (type(self.inner) is BK.FusedBackend
                and BK._stock_pipeline(self.inner, BK.FusedBackend)):
            self._mode = "fused"
        else:
            self._mode = None
        self._buckets: "OrderedDict[tuple, _Bucket]" = OrderedDict()
        self._programs: dict = {}
        self._lock = threading.Lock()
        self._done = None           # CUDA event: the last call's end

    # ----------------------------------------------------------- plumbing
    def bound_ranks(self, rt, users, qs):
        """Full (B, n) bounds come from the inner backend (a debugging
        surface); the elastic program applies to the end-to-end query."""
        return self.inner.bound_ranks(rt, users, qs)

    def build_index(self, users, items, cfg, generator=None, *,
                    positions=None, weights=None):
        return self.inner.build_index(users, items, cfg, generator,
                                      positions=positions, weights=weights)

    def degrade(self, level):
        """Ladder levels act on the wrapped backend."""
        super().degrade(level)
        self.inner.degrade(level)

    def check_users_shape(self, n):
        return self.inner.check_users_shape(n)

    def programs(self) -> list:
        """The programs built by this backend: on the card each reports
        its `replays` and the launches its graph holds (`recorded`),
        which `ops.LAUNCHES` does not count."""
        return list(self._programs.values())

    def _bucket(self, key: tuple, rt, users, corr, cap: int) -> _Bucket:
        """The bucket of `key` (`_bucket_key`), holding this generation."""
        bucket = self._buckets.get(key)
        if bucket is not None:
            self._buckets.move_to_end(key)
            if bucket.holds(rt, users, corr):
                return bucket
        with trace.span("elastic.repad", n=users.shape[0], cap=cap):
            if bucket is None:
                bucket = _Bucket(rt, users, corr, cap)
                self._buckets[key] = bucket
                while len(self._buckets) > self._BUCKETS:
                    _, old = self._buckets.popitem(last=False)
                    self._programs = {k: p for k, p in self._programs.items()
                                      if p.bucket is not old}
            else:
                bucket.refill(rt, users, corr)
        obs.get_default().counter(
            "elastic_repads_total",
            "capacity repads on the device (one per new index generation)"
        ).inc()
        return bucket

    # -------------------------------------------------------------- query
    def _query_via(self, rt, users, qs, *, k, c, delta) -> QueryResult:
        n = users.shape[0]
        cap = capacity_for(n, self.tile)
        fused = self._mode == "fused"
        m_kernel = int(rt.m) if fused else None
        dev = stored_rows(users).device
        with self._lock:
            cur = torch.cuda.current_stream(dev) if dev.type == "cuda" \
                else None
            if cur is not None and self._done is not None:
                cur.wait_event(self._done)
            bkey = _bucket_key(rt, users, delta, cap)
            bucket = self._bucket(bkey, rt, users, delta, cap)
            key = (self.tile, qs.shape[0], int(k), m_kernel, bkey)
            prog = self._programs.get(key)
            if prog is None:
                prog = _Program(bucket, qs.shape[0], qs.shape[1], int(k),
                                fused, m_kernel)
                self._programs[key] = prog
            with trace.span("elastic.dispatch", n=n, batch=qs.shape[0],
                            k=k):
                res = prog.run(qs, n, c, rt.m, delta)
            if cur is not None:
                self._done = torch.cuda.Event()
                self._done.record(cur)
        return res

    def query_batch(self, rt, users, qs, *, k, c, delta=None):
        n = users.shape[0]
        if self._mode is None or k > n:
            # k > n: the sentinel argument needs k ≤ n real rows; the
            # inner backend gives the degenerate case its own behaviour
            if delta is None:
                return self.inner.query_batch(rt, users, qs, k=k, c=c)
            return self.inner.query_batch(rt, users, qs, k=k, c=c,
                                          delta=delta)
        return self._query_via(rt, users, qs.contiguous(), k=k, c=c,
                               delta=delta)

    def dispatch_device(self, rt, users, qs, *, k, c, delta=None):
        """Serving entry: the host block goes straight into the program's
        static query buffer, in one non-blocking copy from a pinned
        buffer, and the copied-out result comes back as device tensors
        with no host sync; bitwise `query_batch` on the same block."""
        n = users.shape[0]
        if self._mode is None or k > n:
            if delta is None:
                return self.inner.dispatch_device(rt, users, qs, k=k, c=c)
            return self.inner.dispatch_device(rt, users, qs, k=k, c=c,
                                              delta=delta)
        dev = stored_rows(users).device
        if not isinstance(qs, torch.Tensor) or qs.device != dev:
            qs = BK.host_block(qs, pinned=dev.type == "cuda")
        return self._query_via(rt, users, qs, k=k, c=c, delta=delta)


@BK.register_wrapper("elastic")
def _make_elastic(inner: str, *, mesh=None) -> ElasticBackend:
    """`get_backend("elastic:<inner>")` lands here."""
    return ElasticBackend(inner, mesh=mesh)
