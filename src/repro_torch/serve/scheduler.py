"""Async micro-batching request scheduler — single queries in, B-sized
`engine.query_batch` ticks out (a port of `repro/serve/scheduler.py`).

The paper's item-centric workload is served ONLINE: queries arrive one at
a time, but the B-query block is the cheap unit of work (the
(n, τ) rank table and (n, d) user matrix are streamed once per block, not
once per query). `MicroBatcher` closes that gap: `submit(q, k, c)`
returns a Future immediately; a dispatcher thread coalesces queued
requests into ticks of up to `max_batch` queries and executes each tick
as ONE `engine.query_batch` call.

Latency-vs-throughput knob
--------------------------
A tick dispatches as soon as any (k, c) group reaches `max_batch` queued
requests, or `max_wait_ms` after the head request arrived — whichever
comes first. Small `max_wait_ms` bounds queueing latency at low offered
load (ticks go out nearly empty); large `max_wait_ms` trades latency for
fill ratio and table-bandwidth amortization (see
`benchmarks/perf_engine.py --serve` for the measured curve). Requests
with different (k, c) never share a tick — k is a static argument of
the batch program — and a FULL group behind a straggler head
dispatches immediately rather than waiting out the head's deadline.

Partial-batch padding
---------------------
Partial ticks are EDGE-PADDED to the `max_batch` shape (`pad_block`), so
every tick reuses one elastic program (one CUDA graph on the card)
instead of building one per fill level; pad rows are sliced off before
the Futures resolve. Padding is numerically invisible: the step-1
kernels compute each query's column with the same operations at any
width, and a plain matmul's column (i, j) depends only on user row i,
query column j and the accumulation order, so the real rows of a padded
tick are bitwise those of dispatching the unpadded block directly
(tests/test_torch_serve.py). A width-1 product may take another
accumulation order, so `pad_block` never emits width-1 dispatches.

Back-pressure
-------------
`max_depth` bounds the queue: a `submit` that would push the queue past
it FAILS FAST with `QueueFull` instead of growing an unbounded backlog
(under sustained overload an unbounded queue turns finite latency into
infinite latency for everyone). Rejections are counted per tick
(`TickStats.rejected` — rejections observed since the previous tick) and
in aggregate (`ServeStats.rejected`, plus the queue-depth high-watermark)
so dashboards can see the overload knee; `benchmarks/perf_engine.py
--serve` sweeps offered load past capacity and reports the column.

Snapshot-pinned ticks
---------------------
When the engine is snapshot-versioned (`repro_torch.index`: mutable engines
publish epoch-versioned `IndexSnapshot`s), every tick PINS one snapshot
(`engine.current_snapshot()`) and dispatches the whole batch against it
via `engine.query_batch_at`, recording the epoch in `TickStats.epoch`.
A concurrent mutation or rebuild hot-swap therefore lands BETWEEN ticks,
never inside one: all futures of a tick resolve against exactly one
index generation. Engines without
snapshots dispatch through plain `engine.query_batch`.

Per-tick stats (`TickStats`) record queue depth at dispatch, fill ratio,
and per-request latency; `MicroBatcher.stats()` aggregates them into
p50/p99 latency for the serving dashboards.

Deadlines, reject reasons, degrade
----------------------------------
`submit(..., deadline_ms=)` attaches a latency budget: an already-expired
submit is rejected at admission, and every tick cut SWEEPS the queue
first, failing expired requests with `DeadlineExceeded` BEFORE they
occupy a tick slot (a request that cannot possibly meet its deadline
must not displace one that can). Every rejection carries a reason label
on the `serve_rejected_total{reason=...}` registry counter: `queue_full`
(max_depth back-pressure), `deadline` (expired at admission or in the
sweep), `shutdown` (submit after close, or queue shed past the bounded
drain of `close(drain_s=...)`), and `degraded` (cache-only rung misses,
see below). `submit` after `close()` raises the typed `SchedulerClosed`
instead of hanging, and `close()` is idempotent.

Passing `degrade=DegradeController(...)` (`serve.degrade`) arms the
certified degrade ladder: the controller observes queue depth at every
tick cut and the tick dispatches at its current rung — rung 2 widens the
served contract to c_eff = c · widen_c (still a certified
c_eff-approximation, recorded in `TickStats.degrade_level` and audited
at c_eff), rung 3 serves LRU hits only and sheds misses. Fault-injection
sites `serve.dispatch` / `serve.slow_tick` / `serve.transfer`
(`serve.faults`) live at the top of the dispatch and completion paths,
one flag check each when disabled.

Overlapped pipeline
-------------------
The hot path is DOUBLE-BUFFERED: a dispatch stage (the dispatcher
thread) and a completion stage (a second thread) connected by a bounded
in-flight queue of ≤ `pipeline_depth` ticks. On the card the dispatcher
runs on a CUDA stream of its own: per tick it makes that stream wait on
the default stream (where the engine's tensors are made), stages the
host block (one copy, `dispatch_batch_at` → `dispatch_device`), launches
the tick's device work, and right after it enqueues the copy of the
whole QueryResult into an in-flight SLOT, pinned host tensors of the
result's shapes (at most `pipeline_depth` of them, allocated once and
reused), and records a CUDA event. Nothing on the dispatch thread waits
for the device. The completion stage waits on the tick's event
(`serve.transfer` span; `TickStats.transfer_ms` is that wait, `copy_ms`
the copy's device time between two events, `copy_bytes` its size),
copies each request's row out of the slot into host memory the result
owns (`rows_ms`), returns the slot, and resolves the futures in dispatch (FIFO)
order; so no later tick can overwrite a result a client holds, and a
held result keeps only its own row alive. On the CPU the tick runs
synchronously on the dispatch thread and the completion stage only
copies the rows out and resolves.

The dispatch stream runs at CUDA priority −1 (`_DISPATCH_STREAM_PRIORITY`),
above the default 0: a `QualityAuditor`'s exact oracle runs on a stream of
its own at priority 0, and the block scheduler then starts a tick's blocks
before the oracle's waiting ones.

`submit` keeps queries as HOST numpy (no per-request copy), and tick
assembly stacks and edge-pads in numpy. When the engine's backend
composes a `CachingBackend`, the LRU lookup is folded into the ADMISSION
path: a `submit` whose exact (query, k, c) is cached for the live
snapshot resolves immediately and never occupies a queue or tick slot
(`ServeStats.admission_hits`).

Results are BIT-IDENTICAL to synchronous dispatch — the pipeline moves
buffers and threads, never values — and every invariant holds with
ticks in flight: a completion-stage failure (e.g. an injected
`serve.transfer` fault) fails exactly that tick's futures typed and
re-credits its reject/expiry attribution to the next cut or the terminal
flush; `close(drain_s=...)` bounds the drain with ≥ 1 tick in flight and
never tears a future; `pipeline_depth=1` degenerates to the synchronous
schedule. `TickStats.inflight` records the pipeline occupancy at each
dispatch; `ServeStats.overlap_efficiency` is the fraction of ticks that
actually overlapped another.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import QueryResult
from repro_torch.obs import registry as obs
from repro_torch.obs import trace
from repro_torch.serve import faults


def pad_block(qs: torch.Tensor, max_batch: int) -> torch.Tensor:
    """Edge-pad a (B, d) query block to the (max_batch, d) dispatch shape.

    Pad rows repeat the last real query: their columns are well-defined on
    every backend and are masked out of results by slicing. B = 0 or
    B > max_batch are caller errors, and so is max_batch < 2: the padded
    width is the dispatch width, and a width-1 product may take another
    accumulation order — the case the module's "dispatches never shrink
    below width 2" bit-identity invariant (module doc) rules out.
    """
    if max_batch < 2:
        raise ValueError(f"max_batch must be >= 2 (width-1 dispatches "
                         f"may change the accumulation order and break "
                         f"partial-tick bit-identity); got {max_batch}")
    b = qs.shape[0]
    if not 1 <= b <= max_batch:
        raise ValueError(f"block of {b} queries does not fit max_batch="
                         f"{max_batch}")
    if b == max_batch:
        return qs
    return torch.cat([qs, qs[-1:].expand(max_batch - b, qs.shape[1])])


def _program_count() -> int:
    """Programs built across the query stack (`core.elastic.
    compiled_program_count`). Deferred import: that module imports the
    backends, which this one must not import at load time."""
    from repro_torch.core.elastic import compiled_program_count
    return compiled_program_count()


def _host_result(res: QueryResult) -> QueryResult:
    """A (device) QueryResult copied to the host, synchronously."""
    return QueryResult(*(x.cpu() for x in res))


def _engine_device(engine) -> torch.device:
    """The device the engine's index lives on (the CPU for an engine
    that holds no users tensor)."""
    snap_fn = getattr(engine, "current_snapshot", None)
    users = (getattr(snap_fn(), "users", None) if snap_fn is not None
             else getattr(engine, "users", None))
    return users.device if isinstance(users, torch.Tensor) \
        else torch.device("cpu")


class QueueFull(RuntimeError):
    """`submit` rejected: the queue is at `max_depth` (back-pressure)."""


class SchedulerClosed(RuntimeError):
    """`submit` after `close()`: the scheduler is shut down (reject
    reason `shutdown`). A RuntimeError subclass so pre-PR-9 callers
    catching the old untyped close error keep working."""


class DeadlineExceeded(RuntimeError):
    """The request's `deadline_ms` budget expired before dispatch —
    at admission, in the per-tick queue sweep, or as a queued casualty
    of a bounded drain (reject reason `deadline`)."""

# Reject-reason label values on serve_rejected_total{reason=...}; the
# catalog is closed so dashboards can enumerate it.
REJECT_REASONS = ("queue_full", "deadline", "shutdown", "degraded")

# CUDA priority of the dispatch stream (lower is higher; 0 is the default
# streams'): above the auditor's oracle stream, so replays go first.
_DISPATCH_STREAM_PRIORITY = -1


@dataclasses.dataclass(frozen=True)
class TickStats:
    """One dispatched tick, as observed by the scheduler."""

    batch: int                 # real (unpadded) queries in the tick
    queue_depth: int           # queue length when the tick was formed
    fill_ratio: float          # batch / max_batch
    wait_ms: float             # head request's submit → dispatch wait
    latencies_ms: Tuple[float, ...]   # per-request submit → resolve
    rejected: int = 0          # submits rejected since the previous tick
    epoch: Optional[int] = None  # pinned index epoch (snapshot engines)
    # Query-stack programs built DURING this tick's dispatch
    # (core.elastic.compiled_program_count delta; each a CUDA graph
    # capture on the card). Nonzero only on warm-up ticks; a nonzero
    # value on a steady-state tick is the rebuild storm the elastic
    # backend exists to prevent.
    compiles: int = 0
    # Deadline sweeps attributed to this tick's cut (expired requests
    # shed from the queue before the tick was formed), and the degrade
    # rung the tick was dispatched at (0 = normal; serve.degrade).
    expired: int = 0
    degrade_level: int = 0
    # A terminal record (batch == 0) is flushed at close() when rejects
    # arrived after the last dispatched tick — every rejection is
    # attributed to exactly one TickStats.
    # Pipeline observability: the completion stage's wait for the tick's
    # device-to-host copy, and the in-flight tick count at the moment
    # this tick was dispatched (self included — 1 means it did not
    # overlap anything; ≥ 2 is the pipelined steady state).
    transfer_ms: float = 0.0
    inflight: int = 1
    # The tick's device-to-host copy of the whole QueryResult (r_lo and
    # r_up included): its device time between two CUDA events, and its
    # bytes (0.0 and the bytes on the CPU, where nothing is copied).
    copy_ms: float = 0.0
    copy_bytes: int = 0
    # The completion stage's host copy of each request's row out of the
    # tick's slot into memory the result owns (wall ms, after the wait).
    rows_ms: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """Aggregate over a MicroBatcher's lifetime (see `stats()`)."""

    ticks: int
    requests: int
    mean_fill: float
    mean_queue_depth: float
    p50_ms: float
    p99_ms: float
    rejected: int = 0          # submits rejected by the max_depth bound
    depth_hwm: int = 0         # queue-depth high-watermark
    expired: int = 0           # requests shed by deadline (admission+sweep)
    # Submits resolved from the LRU on the admission path (their
    # latencies are pooled into the percentiles; they occupy no tick),
    # and the fraction of dispatched ticks that overlapped ≥ 1 other
    # in-flight tick (the pipeline's utilization signal).
    admission_hits: int = 0
    overlap_efficiency: float = 0.0

    def __str__(self):
        return (f"{self.requests} reqs / {self.ticks} ticks  "
                f"fill {self.mean_fill:.2f}  depth {self.mean_queue_depth:.1f}"
                f" (hwm {self.depth_hwm})  rej {self.rejected}"
                f"  exp {self.expired}  adm {self.admission_hits}"
                f"  ovl {self.overlap_efficiency:.2f}"
                f"  p50 {self.p50_ms:.2f} ms  p99 {self.p99_ms:.2f} ms")


class _Request:
    __slots__ = ("q", "k", "c", "future", "t_submit", "t_deadline")

    def __init__(self, q, k, c, deadline_ms=None):
        self.q = q                      # HOST numpy row: queries stay
        self.k = int(k)                 # host-side until the tick's
        self.c = float(c)               # single copy at assembly
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        # absolute monotonic deadline; None = no latency budget
        self.t_deadline = (None if deadline_ms is None
                           else self.t_submit + float(deadline_ms) / 1e3)

    @property
    def key(self):
        return (self.k, self.c)


class _InflightTick:
    """One dispatched-but-uncompleted tick: the unit the completion stage
    consumes. `res` is the tick's QueryResult in HOST tensors that the
    dispatch stream is still filling until `done` (a CUDA event; None on
    the CPU, where `res` is complete); `copy` is the pair of events around
    the copy — nothing here has waited on the device yet."""

    __slots__ = ("reqs", "res", "snap", "epoch", "k", "c_eff", "depth",
                 "rejected", "expired", "level", "t_dispatch", "compiles",
                 "inflight", "done", "copy", "copy_bytes")

    def __init__(self, reqs, res, snap, epoch, k, c_eff, depth, rejected,
                 expired, level, t_dispatch, compiles, done=None, copy=None,
                 copy_bytes=0):
        self.reqs = reqs
        self.res = res
        self.done = done
        self.copy = copy
        self.copy_bytes = copy_bytes
        self.snap = snap
        self.epoch = epoch
        self.k = k
        self.c_eff = c_eff
        self.depth = depth
        self.rejected = rejected
        self.expired = expired
        self.level = level
        self.t_dispatch = t_dispatch
        self.compiles = compiles
        self.inflight = 1       # occupancy at dispatch; set at append


class MicroBatcher:
    """Coalesce async single-query submissions into `query_batch` ticks.

    Usage::

        with MicroBatcher(eng, max_batch=16, max_wait_ms=2.0) as mb:
            futs = [mb.submit(q, k=10, c=2.0) for q in queries]
            results = [f.result() for f in futs]     # QueryResult each
            print(mb.stats())

    Thread-safe; one background dispatcher thread. `close()` (or leaving
    the context) drains the queue before the thread exits, so every
    accepted Future resolves.
    """

    def __init__(self, engine, *, max_batch: int = 16,
                 max_wait_ms: float = 2.0, max_depth: Optional[int] = None,
                 auditor=None, degrade=None, pipeline_depth: int = 2):
        # Width 1 is rejected, not padded around: the module's partial-tick
        # bit-identity argument needs every dispatch ≥ 2 wide (module
        # doc), and a max_batch=1 scheduler could never form a wider tick.
        if max_batch < 2:
            raise ValueError(f"max_batch must be >= 2 (width-1 dispatches "
                             f"may change the accumulation order and break "
                             f"partial-tick bit-identity), got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_depth = None if max_depth is None else int(max_depth)
        # Ticks allowed in flight (dispatched, not yet completed): 1 is
        # the synchronous schedule, 2 the double-buffered default — the
        # completion stage of tick t overlaps the device work of t+1.
        self.pipeline_depth = int(pipeline_depth)
        # Optional shadow auditor, duck-typed (`observe(q, result, k=, c=,
        # snapshot=)`, as the reference's QualityAuditor): every resolved
        # request is OFFERED to it with the pinned snapshot.
        self.auditor = auditor
        # Optional degrade-ladder controller (serve.degrade): asked
        # for the current rung at every tick cut; None = always rung 0.
        self.degrade = degrade
        reg = obs.get_default()
        self._m_submitted = reg.counter(
            "serve_requests_total", "requests accepted by submit()")
        self._m_rejected = reg.counter(
            "serve_rejected_total", "submits rejected by back-pressure")
        # Per-reason reject counters (same metric name, a `reason` label
        # per REJECT_REASONS value; the unlabelled aggregate above stays
        # for pre-PR-9 dashboards).
        self._m_reject_reason = {
            reason: reg.counter(
                "serve_rejected_total", "rejects by reason",
                labels={"reason": reason})
            for reason in REJECT_REASONS}
        self._m_ticks = reg.counter(
            "serve_ticks_total", "dispatched micro-batch ticks")
        self._m_compiles = reg.counter(
            "serve_compiles_total", "programs built during ticks")
        self._m_depth = reg.gauge(
            "serve_queue_depth", "queue length at the last tick cut")
        self._m_fill = reg.gauge(
            "serve_tick_fill_ratio", "fill ratio of the last tick")
        self._m_latency = reg.histogram(
            "serve_request_latency_ms", "submit → resolve latency")
        self._m_wait = reg.histogram(
            "serve_queue_wait_ms", "submit → dispatch queue wait")
        self._m_inflight = reg.gauge(
            "serve_inflight_ticks",
            "ticks dispatched but not yet completed")
        self._m_transfer = reg.histogram(
            "serve_transfer_ms", "per-tick wait for the D2H copy")
        self._m_admission = reg.counter(
            "serve_admission_hits_total",
            "submits resolved from the LRU at admission")
        self._queue: Deque[_Request] = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._closed = False        # close() already ran (idempotency)
        self._drain_deadline = None  # monotonic bound on close() draining
        self._flush = False
        self._busy = False          # a tick is being dispatched right now
        self._ticks: List[TickStats] = []
        self._rejected_total = 0
        self._rejected_since_tick = 0
        self._expired_total = 0
        self._expired_since_tick = 0
        self._depth_hwm = 0
        # The pipeline's bounded in-flight queue: dispatch appends,
        # completion peeks/pops FIFO (so futures resolve in dispatch
        # order and flush() sees a tick until it is fully resolved).
        self._inflight: Deque[_InflightTick] = deque()
        self._complete_stop = False
        self._admission_hits = 0
        self._admission_lat: List[float] = []
        # Admission-path LRU: when the engine's backend composes
        # a CachingBackend AND the engine is snapshot-versioned, submit
        # probes the cache first — a hit resolves immediately and never
        # occupies a queue or tick slot.
        self._admission_cache = None
        if getattr(engine, "current_snapshot", None) is not None:
            bk = getattr(engine, "_backend", None)
            if bk is not None:
                from repro_torch.serve.degrade import find_cache
                self._admission_cache = find_cache(bk)
        # On the card the dispatch stage runs on a stream of its own
        self._device = _engine_device(engine)
        self._stream = (torch.cuda.Stream(self._device,
                                          priority=_DISPATCH_STREAM_PRIORITY)
                        if self._device.type == "cuda" else None)
        # free in-flight slots of pinned host tensors (card only); a tick
        # holds one from its dispatch until its rows are copied out
        self._slots: List[QueryResult] = []
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatcher")
        self._complete_thread = threading.Thread(
            target=self._completion_loop, daemon=True,
            name="microbatcher-complete")
        self._thread.start()
        self._complete_thread.start()

    # ------------------------------------------------------------- client
    def submit(self, q, k: int, c: float,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one (d,) query (numpy or a tensor); resolves to its
        per-query QueryResult of HOST (CPU) tensors, leading batch axis
        already squeezed, owning its memory — serving results are
        client-bound, so the tick is copied to the host once and each
        request's row copied out of it.

        With `max_depth` set, a submit that finds the queue at the bound
        raises `QueueFull` immediately (fail-fast back-pressure) instead
        of accepting work the scheduler cannot keep up with.

        `deadline_ms` attaches a latency budget relative to NOW: a
        non-positive budget is rejected at admission with
        `DeadlineExceeded`, and a queued request whose budget expires
        before its tick is cut is failed by the per-tick sweep (its
        Future raises `DeadlineExceeded`). After `close()`, submits
        raise `SchedulerClosed` (reject reason `shutdown`).

        The query is kept as HOST numpy until tick assembly (no
        per-submit copy), and when the engine's backend composes a
        CachingBackend an exact LRU hit for the live snapshot resolves
        the Future right here — it never occupies a queue or tick slot
        (`ServeStats.admission_hits`)."""
        if isinstance(q, torch.Tensor):
            q = q.detach().cpu().numpy()
        q = np.asarray(q)
        if q.ndim != 1:
            raise ValueError(f"submit expects a (d,) query; got {q.shape}")
        if q.dtype != np.float32:
            # the engine's dtype, so that host-resident submission
            # changes no tick bytes
            q = q.astype(np.float32)
        if deadline_ms is not None and deadline_ms <= 0:
            # already expired at admission: shed before it can take a
            # queue slot, let alone a tick slot
            with self._cond:
                self._expired_total += 1
                self._expired_since_tick += 1
            self._m_reject_reason["deadline"].inc()
            raise DeadlineExceeded(
                f"deadline_ms={deadline_ms} already expired at submit")
        if self._admission_cache is not None and not self._stop:
            fut = self._admission_probe(q, int(k), float(c))
            if fut is not None:
                return fut
        req = _Request(q, k, c, deadline_ms=deadline_ms)
        with self._cond:
            if self._stop:
                # Not counted into _rejected_total: the dispatcher has
                # (or will have) exited, so no terminal TickStats could
                # attribute it — the labelled counter is the record.
                self._m_reject_reason["shutdown"].inc()
                raise SchedulerClosed("MicroBatcher is closed")
            if (self.max_depth is not None
                    and len(self._queue) >= self.max_depth):
                self._rejected_total += 1
                self._rejected_since_tick += 1
                self._m_rejected.inc()
                self._m_reject_reason["queue_full"].inc()
                raise QueueFull(
                    f"queue at max_depth={self.max_depth}; request rejected "
                    "(fail-fast back-pressure — retry with backoff)")
            self._queue.append(req)
            self._depth_hwm = max(self._depth_hwm, len(self._queue))
            self._cond.notify_all()
        self._m_submitted.inc()
        return req.future

    def _admission_probe(self, q: np.ndarray, k: int,
                         c: float) -> Optional[Future]:
        """LRU probe on the admission path: a resolved Future when the
        exact (query, k, c) is cached for the live snapshot, else None
        (the request then takes the normal queue path). Misses are not
        counted against the cache's hit-rate (`record_miss=False`) —
        they go on to dispatch through the backend, which counts them.
        A cached entry may still be in the making on the dispatch
        stream, so the copy to the host waits for that stream first."""
        t0 = time.monotonic()
        snap = self.engine.current_snapshot()
        res = self._admission_cache.lookup_only(
            snap.rank_table, snap.query_users(), q, k=k, c=c,
            delta=snap.corr, record_miss=False)
        if res is None:
            return None
        if self._stream is not None:
            torch.cuda.current_stream(self._device).wait_stream(self._stream)
        host = _host_result(res)
        lat_ms = (time.monotonic() - t0) * 1e3
        with self._cond:
            self._admission_hits += 1
            self._admission_lat.append(lat_ms)
        self._m_submitted.inc()
        self._m_admission.inc()
        self._m_latency.observe(lat_ms)
        fut: Future = Future()
        fut.set_result(host)
        if self.auditor is not None:
            self.auditor.observe(np.asarray(q), host, k=k, c=c,
                                 snapshot=snap)
        return fut

    def flush(self) -> None:
        """Dispatch everything queued without waiting out `max_wait_ms`,
        and block until all accepted requests have resolved."""
        with self._cond:
            self._flush = True
            self._cond.notify_all()
            while self._queue or self._busy or self._inflight:
                self._cond.wait(timeout=0.05)
            self._flush = False

    def close(self, drain_s: Optional[float] = None) -> None:
        """Drain the queue, then stop the dispatcher thread. Idempotent —
        a second close() returns immediately.

        `drain_s` bounds the drain: queued requests still undispatched
        when the budget runs out are shed (`SchedulerClosed`, reject
        reason `shutdown`) instead of holding up shutdown behind a slow
        engine. The default None drains fully, as before."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            if drain_s is not None:
                self._drain_deadline = time.monotonic() + float(drain_s)
            self._cond.notify_all()
        self._thread.join()
        # The dispatcher's exit signalled the completion stage to drain
        # the remaining in-flight ticks and flush the terminal record;
        # joining it makes close() a full barrier (every accepted Future
        # resolved, every reject attributed) exactly as before.
        self._complete_thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> ServeStats:
        """Aggregate tick statistics (p50/p99 over request latencies,
        admission-path hits pooled in)."""
        with self._cond:            # one atomic snapshot of ticks+counters
            ticks = list(self._ticks)
            rejected, hwm = self._rejected_total, self._depth_hwm
            expired = self._expired_total
            adm = self._admission_hits
            adm_lat = list(self._admission_lat)
        if not ticks and not adm_lat:
            return ServeStats(0, 0, 0.0, 0.0, 0.0, 0.0, rejected=rejected,
                              depth_hwm=hwm, expired=expired,
                              admission_hits=adm)
        # The terminal rejection record (batch == 0, no latencies) is an
        # accounting tick: it carries rejects into the aggregate but must
        # not skew the dispatch-shape means or crash the percentiles.
        dispatched = [t for t in ticks if t.batch > 0]
        lats = np.concatenate(
            [np.asarray(t.latencies_ms, dtype=float) for t in ticks]
            + [np.asarray(adm_lat, dtype=float)])
        return ServeStats(
            ticks=len(ticks),
            requests=int(lats.size),
            mean_fill=(float(np.mean([t.fill_ratio for t in dispatched]))
                       if dispatched else 0.0),
            mean_queue_depth=(
                float(np.mean([t.queue_depth for t in dispatched]))
                if dispatched else 0.0),
            p50_ms=float(np.percentile(lats, 50)) if lats.size else 0.0,
            p99_ms=float(np.percentile(lats, 99)) if lats.size else 0.0,
            rejected=rejected,
            depth_hwm=hwm,
            expired=expired,
            admission_hits=adm,
            overlap_efficiency=(
                float(np.mean([t.inflight > 1 for t in dispatched]))
                if dispatched else 0.0),
        )

    @property
    def tick_log(self) -> List[TickStats]:
        with self._cond:
            return list(self._ticks)

    # --------------------------------------------------------- dispatcher
    def _full_key(self):
        """The (k, c) of the first group to reach `max_batch` queued
        requests, or None. Requests with different static args cannot
        share a tick (k keys the batch program), but a
        FULL group behind a lone straggler head is dispatchable NOW —
        waiting out the head's deadline would be head-of-line blocking."""
        counts: dict = {}
        for r in self._queue:
            counts[r.key] = counts.get(r.key, 0) + 1
            if counts[r.key] >= self.max_batch:
                return r.key
        return None

    def _sweep_expired(self, now: float) -> List[_Request]:
        """Remove deadline-expired requests from the queue (lock held).
        Returns the shed requests — their futures are failed OUTSIDE the
        lock (`_fail_expired`), so a future callback can never deadlock
        against the scheduler."""
        if not any(r.t_deadline is not None and now >= r.t_deadline
                   for r in self._queue):
            return []
        keep: Deque[_Request] = deque()
        dead: List[_Request] = []
        for r in self._queue:
            if r.t_deadline is not None and now >= r.t_deadline:
                dead.append(r)
            else:
                keep.append(r)
        self._queue = keep
        self._expired_total += len(dead)
        self._expired_since_tick += len(dead)
        return dead

    def _fail_expired(self, reqs: List[_Request]) -> None:
        for r in reqs:
            self._m_reject_reason["deadline"].inc()
            if not r.future.cancelled():
                r.future.set_exception(DeadlineExceeded(
                    "deadline expired before dispatch (per-tick sweep)"))

    def _fail_drained(self, reqs: List[_Request]) -> None:
        for r in reqs:
            self._m_reject_reason["shutdown"].inc()
            if not r.future.cancelled():
                r.future.set_exception(SchedulerClosed(
                    "scheduler closed before dispatch (bounded drain)"))

    def _loop(self):
        while True:
            expired: List[_Request] = []
            drained: List[_Request] = []
            reqs = None
            terminal = False
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait()
                now = time.monotonic()
                # Deadline sweep FIRST: an expired request must not be
                # chosen as the head nor occupy a tick slot.
                expired += self._sweep_expired(now)
                if (self._stop and self._queue
                        and self._drain_deadline is not None
                        and now >= self._drain_deadline):
                    # bounded drain exhausted: shed the remainder so
                    # close(drain_s=...) returns promptly; the sheds flow
                    # into the terminal accounting record below
                    drained = list(self._queue)
                    self._queue.clear()
                    self._rejected_total += len(drained)
                    self._rejected_since_tick += len(drained)
                if not self._queue:
                    if self._stop:      # stop requested, queue drained
                        # Hand off to the completion stage: in-flight
                        # ticks may still fail and re-credit their
                        # reject/expiry attribution, so the terminal
                        # accounting record is flushed THERE, after the
                        # pipeline drains (`_completion_loop`).
                        self._complete_stop = True
                        self._cond.notify_all()
                        terminal = True
                    # else: the sweep emptied the queue mid-serve — fail
                    # the shed futures below and go back to waiting
                else:
                    # Pipeline back-pressure: at most `pipeline_depth`
                    # ticks in flight; completion pops wake this wait. A
                    # bounded drain that expires while waiting falls
                    # through (reqs stays None) to the top-of-loop shed
                    # instead of cutting past the depth bound.
                    while len(self._inflight) >= self.pipeline_depth:
                        if (self._stop and self._drain_deadline is not None
                                and time.monotonic()
                                >= self._drain_deadline):
                            break
                        self._cond.wait(timeout=0.05)
                    if len(self._inflight) < self.pipeline_depth:
                        # a budget may have lapsed during the slot wait
                        expired += self._sweep_expired(time.monotonic())
                    if (len(self._inflight) < self.pipeline_depth
                            and self._queue):
                        head = self._queue[0]
                        deadline = head.t_submit + self.max_wait_ms / 1e3
                        while (self._full_key() is None
                               and not (self._stop or self._flush)):
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                break
                            self._cond.wait(timeout=remaining)
                        # late sweep: a request whose budget ran out
                        # DURING the coalescing wait must not take a
                        # tick slot
                        expired += self._sweep_expired(time.monotonic())
                        if self._queue:
                            # a full group anywhere in the queue outranks
                            # the partial head tick; the head still
                            # dispatches by its deadline
                            key = self._full_key() or self._queue[0].key
                            reqs, rest = [], deque()
                            while self._queue:
                                r = self._queue.popleft()
                                if (r.key == key
                                        and len(reqs) < self.max_batch):
                                    reqs.append(r)
                                else:
                                    rest.append(r)
                            depth = len(reqs) + len(rest)
                            self._queue = rest
                            rejected = self._rejected_since_tick
                            self._rejected_since_tick = 0
                            n_expired = self._expired_since_tick
                            self._expired_since_tick = 0
                            # degrade rung for this tick, from the queue
                            # depth observed at the cut (hysteresis
                            # inside the controller — serve.degrade)
                            level = (self.degrade.on_tick_cut(depth)
                                     if self.degrade is not None else 0)
                            self._busy = True
            if expired:
                self._fail_expired(expired)
            if drained:
                self._fail_drained(drained)
            if terminal:
                return
            if reqs is None:
                continue
            try:
                self._dispatch(reqs, depth, rejected, n_expired, level)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _assemble_block(self, reqs: List[_Request]) -> np.ndarray:
        """Host-side tick assembly: stack and edge-pad the HOST query rows
        in numpy, so the whole tick pays exactly ONE host-to-device copy
        (inside the backend's `dispatch_device`). Pad semantics match
        `pad_block` exactly — same bytes, so bit-identity to the
        synchronous path is preserved."""
        qs = np.stack([r.q for r in reqs])
        b = qs.shape[0]
        if b < self.max_batch:
            qs = np.concatenate(
                [qs, np.broadcast_to(qs[-1:],
                                     (self.max_batch - b, qs.shape[1]))])
        return qs

    def _dispatch(self, reqs: List[_Request], depth: int, rejected: int = 0,
                  expired: int = 0, level: int = 0):
        """DISPATCH stage: assemble, stage, and launch the tick's device
        work and its copy to pinned host tensors, then hand an
        `_InflightTick` to the completion stage — no host sync on this
        thread (`_complete` waits on the tick's event)."""
        t_dispatch = time.monotonic()
        k, c = reqs[0].key
        # rung 2+ of the degrade ladder dispatches at a WIDENED contract:
        # the result is a valid c_eff-approximation, reported as such
        # (TickStats.degrade_level) and audited at c_eff (module doc)
        c_eff = (self.degrade.widened_c(c)
                 if self.degrade is not None else c)
        if (level >= 3 and self.degrade is not None
                and self.degrade.cache is not None
                and getattr(self.engine, "current_snapshot", None)
                is not None):
            self._dispatch_cache_only(reqs, depth, rejected, expired,
                                      level, t_dispatch)
            return
        epoch = None
        snap = None
        done = copy = None
        copy_bytes = 0
        programs_before = _program_count()
        sp = trace.span("serve.tick", batch=len(reqs), depth=depth, k=k)
        stream_ctx = (torch.cuda.stream(self._stream)
                      if self._stream is not None
                      else contextlib.nullcontext())
        try:
            with sp, stream_ctx:
                if faults.ACTIVE is not None:
                    faults.fire("serve.slow_tick")
                    faults.fire("serve.dispatch")
                if trace.is_enabled():
                    # retroactive cross-thread spans: each request's
                    # admission → dispatch queue wait, timed from its
                    # client-thread submit; inside the tick span so the
                    # records attribute to the tick that served them
                    for r in reqs:
                        trace.event("serve.queue_wait", r.t_submit,
                                    t_dispatch - r.t_submit, k=k)
                qs = self._assemble_block(reqs)
                # Pin ONE index snapshot for the whole tick (module doc):
                # a hot-swap concurrent with this dispatch lands between
                # ticks, never inside one.
                snap_fn = getattr(self.engine, "current_snapshot", None)
                dispatch_fn = getattr(self.engine, "dispatch_batch_at",
                                      None)
                if self._stream is not None:
                    # the engine's tensors are made on the default stream
                    self._stream.wait_stream(
                        torch.cuda.default_stream(self._device))
                if snap_fn is not None:
                    snap = snap_fn()
                    epoch = getattr(snap, "epoch", None)
                    sp.set(epoch=epoch)
                    if dispatch_fn is not None:
                        # the serving entry: one host-to-device copy,
                        # device tensors out, no host sync
                        res = dispatch_fn(snap, qs, k=k, c=c_eff)
                    else:
                        res = self.engine.query_batch_at(
                            snap, torch.from_numpy(qs), k=k, c=c_eff)
                else:
                    res = self.engine.query_batch(torch.from_numpy(qs), k=k,
                                                  c=c_eff)
                copy_bytes = sum(x.numel() * x.element_size() for x in res
                                 if isinstance(x, torch.Tensor))
                if self._stream is not None:
                    res, done, copy = self._copy_to_host(res)
        except Exception as e:                    # propagate to every caller
            for r in reqs:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            # This tick records no TickStats — re-credit the rejects and
            # expiries it was carrying so the NEXT cut (or the terminal
            # flush at close) attributes them instead of dropping them.
            with self._cond:
                self._rejected_since_tick += rejected
                self._expired_since_tick += expired
            return
        # Compile attribution is sampled HERE, not in the completion
        # stage: tracing/compilation happens synchronously on this
        # thread, so the delta cleanly brackets this tick's dispatch even
        # with other ticks in flight.
        tick = _InflightTick(
            reqs, res, snap, epoch, k, c_eff, depth, rejected, expired,
            level, t_dispatch,
            compiles=max(0, _program_count() - programs_before),
            done=done, copy=copy, copy_bytes=copy_bytes)
        with self._cond:
            self._inflight.append(tick)
            tick.inflight = len(self._inflight)
            self._m_inflight.set(len(self._inflight))
            self._cond.notify_all()

    def _take_slot(self, res: QueryResult) -> QueryResult:
        """A free in-flight slot of pinned host tensors shaped as `res`.
        At most `pipeline_depth` ticks are in flight and each gives its
        slot back before it leaves the in-flight queue, so a free slot
        exists but after a change of shape (a new n), when the old slots
        are dropped and one of the new shape is allocated."""
        want = [(x.shape, x.dtype) for x in res]
        with self._cond:
            while self._slots:
                slot = self._slots.pop()
                if [(x.shape, x.dtype) for x in slot] == want:
                    return slot
        return type(res)(*(torch.empty(x.shape, dtype=x.dtype,
                                       pin_memory=True) for x in res))

    def _copy_to_host(self, res: QueryResult):
        """Enqueue the copy of the tick's whole QueryResult into a free
        in-flight slot on the dispatch stream (the current one), between
        two timing events. Returns (slot, done event, (start, end)
        events)."""
        host = self._take_slot(res)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for h, x in zip(host, res):
            h.copy_(x, non_blocking=True)
        end.record()
        return host, end, (start, end)

    # --------------------------------------------------------- completion
    def _completion_loop(self):
        """COMPLETION stage: consume in-flight ticks FIFO, each with one
        blocking D2H, and resolve futures — entirely off the dispatch
        path. Exits after the dispatcher signals `_complete_stop` and the
        pipeline drains, flushing the terminal accounting record last (a
        completion-stage failure re-credits rejects, so the terminal
        flush must come after the final tick settles)."""
        while True:
            with self._cond:
                while not self._inflight and not self._complete_stop:
                    self._cond.wait()
                if not self._inflight:          # stopping and drained
                    tail = self._rejected_since_tick
                    self._rejected_since_tick = 0
                    tail_exp = self._expired_since_tick
                    self._expired_since_tick = 0
                    if tail or tail_exp:
                        self._ticks.append(TickStats(
                            batch=0, queue_depth=0, fill_ratio=0.0,
                            wait_ms=0.0, latencies_ms=(),
                            rejected=tail, expired=tail_exp))
                    self._cond.notify_all()
                    return
                # PEEK, don't pop: flush()/close() must keep seeing the
                # tick until its futures are resolved.
                tick = self._inflight[0]
            self._complete(tick)
            with self._cond:
                self._inflight.popleft()
                self._m_inflight.set(len(self._inflight))
                self._cond.notify_all()

    def _complete(self, t: _InflightTick):
        reqs = t.reqs
        t_transfer = time.monotonic()
        try:
            with trace.span("serve.transfer", batch=len(reqs),
                            epoch=t.epoch, inflight=t.inflight):
                if faults.ACTIVE is not None:
                    faults.fire("serve.transfer")
                # the one wait per tick: the copy into the tick's slot
                # was enqueued at dispatch. A device fault surfaces here
                # and is failed typed below (the slot is then dropped).
                if t.done is not None:
                    t.done.synchronize()
                t_rows = time.monotonic()
                # each request's row copied out of the slot into memory
                # its result owns, and the slot returned
                rows = [type(t.res)(*(x[i].clone() for x in t.res))
                        for i in range(len(reqs))]
                if t.done is not None:
                    with self._cond:
                        self._slots.append(t.res)
        except Exception as e:
            # Fail exactly THIS tick's futures; later in-flight ticks
            # keep completing. Reject/expiry attribution re-credits to
            # the next cut or the terminal flush (invariant: every
            # reject lands in exactly one TickStats).
            for r in reqs:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            with self._cond:
                self._rejected_since_tick += t.rejected
                self._expired_since_tick += t.expired
            return
        now = time.monotonic()
        transfer_ms = (t_rows - t_transfer) * 1e3
        copy_ms = (t.copy[0].elapsed_time(t.copy[1])
                   if t.copy is not None else 0.0)
        tick = TickStats(
            batch=len(reqs), queue_depth=t.depth,
            fill_ratio=len(reqs) / self.max_batch,
            wait_ms=(t.t_dispatch - reqs[0].t_submit) * 1e3,
            latencies_ms=tuple((now - r.t_submit) * 1e3 for r in reqs),
            rejected=t.rejected, epoch=t.epoch,
            compiles=t.compiles,
            expired=t.expired, degrade_level=t.level,
            transfer_ms=transfer_ms, inflight=t.inflight,
            copy_ms=copy_ms, copy_bytes=t.copy_bytes,
            rows_ms=(now - t_rows) * 1e3)
        # Record the tick BEFORE resolving futures: a client that wakes
        # from f.result() must already see it in stats()/tick_log.
        with self._cond:
            self._ticks.append(tick)
        self._m_ticks.inc()
        if tick.compiles:
            self._m_compiles.inc(tick.compiles)
        self._m_depth.set(t.depth)
        self._m_fill.set(tick.fill_ratio)
        self._m_transfer.observe(transfer_ms)
        for r in reqs:
            self._m_wait.observe((t.t_dispatch - r.t_submit) * 1e3)
            self._m_latency.observe((now - r.t_submit) * 1e3)
        for r, per_q in zip(reqs, rows):          # pad rows masked out here
            if not r.future.cancelled():
                r.future.set_result(per_q)
            if self.auditor is not None:
                # audited at the contract actually served (c_eff on
                # degraded ticks) — the accuracy gauge judges the
                # relaxed, REPORTED contract, not the requested one
                self.auditor.observe(np.asarray(r.q), per_q, k=t.k,
                                     c=t.c_eff, snapshot=t.snap)

    def _dispatch_cache_only(self, reqs: List[_Request], depth: int,
                             rejected: int, expired: int, level: int,
                             t_dispatch: float):
        """Degrade rung 3: answer LRU hits against the pinned snapshot,
        shed misses with `QueueFull` (reject reason `degraded`).

        A hit is an exact per-query result computed earlier in the SAME
        index generation — the cache invalidates on any snapshot change
        (`CachingBackend._check_epoch`), so its certified (r↓, r↑) bounds
        are as valid as at first compute. Misses shed instead of
        dispatching: rung 3 exists to take the rank table out of the
        serving path entirely."""
        cache = self.degrade.cache
        k, c = reqs[0].key
        c_eff = self.degrade.widened_c(c)
        snap = self.engine.current_snapshot()
        epoch = getattr(snap, "epoch", None)
        rt, users, delta = snap.rank_table, snap.query_users(), snap.corr
        hits: List[Tuple[_Request, object, float]] = []
        misses: List[_Request] = []
        with trace.span("serve.cache_only", batch=len(reqs), depth=depth,
                        k=k, epoch=epoch, level=level):
            for r in reqs:
                row = np.asarray(r.q)       # host already (submit)
                # entries may have been cached at the base contract or at
                # the rung-2 widened one — a hit at either serves
                res, c_hit = None, c
                for c_try in ((c, c_eff) if c_eff != c else (c,)):
                    res = cache.lookup_only(rt, users, row, k=k, c=c_try,
                                            delta=delta)
                    if res is not None:
                        c_hit = c_try
                        break
                if res is None:
                    misses.append(r)
                else:
                    hits.append((r, res, c_hit))
            if hits:
                # ONE copy to the host for the whole rung-3 tick: the
                # cached per-query device results are stacked per field
                # first (a copy each would be B blocking transfers)
                if self._stream is not None:
                    torch.cuda.current_stream(self._device).wait_stream(
                        self._stream)
                stacked = _host_result(QueryResult(*(
                    torch.stack(xs) for xs in zip(*(res for _, res, _
                                                    in hits)))))
                hits = [(r, QueryResult(*(x[j] for x in stacked)), c_hit)
                        for j, (r, _, c_hit) in enumerate(hits)]
        with self._cond:
            self._rejected_total += len(misses)
        now = time.monotonic()
        tick = TickStats(
            batch=len(hits), queue_depth=depth,
            fill_ratio=len(hits) / self.max_batch,
            wait_ms=(t_dispatch - reqs[0].t_submit) * 1e3,
            latencies_ms=tuple((now - r.t_submit) * 1e3
                               for r, _, _ in hits),
            rejected=rejected + len(misses), epoch=epoch,
            expired=expired, degrade_level=level)
        with self._cond:
            self._ticks.append(tick)
        self._m_ticks.inc()
        self._m_depth.set(depth)
        self._m_fill.set(tick.fill_ratio)
        if misses:
            self._m_rejected.inc(len(misses))
            self._m_reject_reason["degraded"].inc(len(misses))
        for r in misses:
            if not r.future.cancelled():
                r.future.set_exception(QueueFull(
                    "shed at degrade level 3 (cache-only serving): "
                    "no cached result for this query"))
        for r, host, c_hit in hits:
            self._m_wait.observe((t_dispatch - r.t_submit) * 1e3)
            self._m_latency.observe((now - r.t_submit) * 1e3)
            if not r.future.cancelled():
                r.future.set_result(host)
            if self.auditor is not None:
                self.auditor.observe(np.asarray(r.q), host, k=k, c=c_hit,
                                     snapshot=snap)
