"""Online quality auditor: shadow-sample served queries, re-score them
EXACTLY in the background, publish rolling §5 quality gauges.

Counterpart of `repro/obs/audit.py`:

  * `observe(q, result, k=, c=, snapshot=)` is called by the serving path
    (`MicroBatcher(auditor=)` offers it every resolved request with its
    pinned snapshot). A seeded `random.Random` draws once per
    observation, sampled or not, so the audited subset is a pure
    function of (seed, observation order);
  * sampled queries are queued (bounded; overflow counts
    `audit_dropped_total` instead of pushing back on serving) and
    re-scored on ONE background thread against the exact oracle
    (`core.exact`, K3 on the card) on the snapshot they were served from:
    its f32 users and its live items;
  * rolling windows of per-query overall ratio and accuracy
    (`core.metrics`, the §5 criteria) and of the mean certified width
    r↑ − r↓ over the selected users feed the gauges
    `audit_overall_ratio`, `audit_accuracy` and `audit_bound_width`.

On the card, two things differ from the reference:

  * one K3 launch a sampled query: the exact ranks are computed once and
    the exact answer is `query.smallest_k` of them, what
    `exact.reverse_k_ranks` would compute with a second launch;
  * K3 runs on a CUDA stream of the auditor's own, never on the default
    stream, which the serving dispatch stream waits on at every tick.
    When a sample is enqueued, an event is recorded on the default
    stream, and the auditor's stream waits on it before it reads the
    snapshot's tensors. K3's blocks still share the SMs with the serving
    replays while they run.

The module imports numpy and the stdlib only; torch, the oracle and the
fault catalog are imported when first needed, so `repro_torch.obs`
exports `QualityAuditor` without importing this module up front.
"""
from __future__ import annotations

import contextlib
import logging
import random
import threading
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.obs import registry as obs


def _faults():
    from repro_torch.serve import faults
    return faults


def _np(x) -> np.ndarray:
    """A result field as a host numpy array (tensors are copied back)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class QualityAuditor:
    """Shadow-sampling exact re-scorer (module docstring).

    Args:
      engine:      a `ReverseKRanksEngine` (or anything exposing
                   `current_snapshot()` with `.users` / `.live_items()`).
      fraction:    probability that an observed request is audited.
      seed:        RNG seed; sampling is deterministic in observe order.
      window:      rolling-window length of the quality gauges.
      max_pending: bound on queued, unscored samples; overflow drops
                   (counted), never blocks the caller.
      registry:    metrics registry (default: the process-global one).
    """

    def __init__(self, engine, *, fraction: float = 0.02, seed: int = 0,
                 window: int = 64, max_pending: int = 128,
                 registry: Optional[obs.MetricsRegistry] = None):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1]; got {fraction}")
        if window < 1:
            raise ValueError(f"window must be >= 1; got {window}")
        self.engine = engine
        self.fraction = float(fraction)
        self.window = int(window)
        self.max_pending = int(max_pending)
        self._rng = random.Random(int(seed))
        self._ratios: deque = deque(maxlen=self.window)
        self._accs: deque = deque(maxlen=self.window)
        self._widths: deque = deque(maxlen=self.window)
        self._pending: deque = deque()
        self._cond = threading.Condition()
        self._in_flight = 0
        self._stop = False
        self._stream = None         # the scorer's CUDA stream, made lazily
        reg = registry if registry is not None else obs.get_default()
        self._m_observed = reg.counter(
            "audit_observed_total", "requests offered to the auditor")
        self._m_sampled = reg.counter(
            "audit_sampled_total", "requests sampled for exact re-scoring")
        self._m_scored = reg.counter(
            "audit_scored_total", "samples re-scored against the oracle")
        self._m_dropped = reg.counter(
            "audit_dropped_total", "samples dropped (queue at max_pending)")
        self._m_skipped = reg.counter(
            "audit_skipped_total",
            "samples skipped (snapshot lacks its item set)")
        self._m_ratio = reg.gauge(
            "audit_overall_ratio",
            "rolling mean §5 overall-ratio of audited served queries")
        self._m_acc = reg.gauge(
            "audit_accuracy",
            "rolling mean §5 accuracy of audited served queries")
        self._m_width = reg.gauge(
            "audit_bound_width",
            "rolling mean certified r_up - r_lo over selected users")
        self._m_backlog = reg.gauge(
            "audit_backlog", "sampled queries awaiting exact re-scoring")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="quality-auditor")
        # liveness read at scrape time by a callback: a dead scorer
        # thread cannot leave a stale "alive" value behind
        self._m_alive = reg.gauge(
            "audit_thread_alive",
            "1 while the auditor's scoring thread is running",
            set_fn=self._thread.is_alive)
        self._thread.start()

    # --------------------------------------------------------- serving API
    def observe(self, q, result, *, k: int, c: float,
                snapshot=None) -> bool:
        """Offer one served (query, per-query QueryResult); True when it
        was sampled AND enqueued. Cheap on the serving path: one RNG
        draw, one deque append (and on the card one event record). The
        draw happens for EVERY observation, so the audited subset is a
        pure function of (seed, observation order)."""
        self._m_observed.inc()
        sampled = self._rng.random() < self.fraction
        if not sampled:
            return False
        self._m_sampled.inc()
        if snapshot is None:
            snap_fn = getattr(self.engine, "current_snapshot", None)
            snapshot = snap_fn() if snap_fn is not None else None
        ready = None
        users = getattr(snapshot, "users", None)
        if getattr(users, "is_cuda", False):
            import torch
            # the snapshot's tensors are made on the default stream
            ready = torch.cuda.Event()
            ready.record(torch.cuda.default_stream(users.device))
        with self._cond:
            if self._stop:
                return False
            if len(self._pending) >= self.max_pending:
                self._m_dropped.inc()
                return False
            self._pending.append((np.array(q, dtype=np.float32, copy=True),
                                  result, int(k), float(c), snapshot,
                                  ready))
            self._m_backlog.set(len(self._pending))
            self._cond.notify_all()
        return True

    # ------------------------------------------------------------- results
    @property
    def overall_ratio(self) -> float:
        """Rolling-window mean overall ratio (nan before the first score)."""
        with self._cond:
            return (float(np.mean(self._ratios)) if self._ratios
                    else float("nan"))

    @property
    def accuracy(self) -> float:
        with self._cond:
            return (float(np.mean(self._accs)) if self._accs
                    else float("nan"))

    @property
    def bound_width(self) -> float:
        with self._cond:
            return (float(np.mean(self._widths)) if self._widths
                    else float("nan"))

    @property
    def scored(self) -> int:
        return int(self._m_scored.value)

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued sample has been scored; False on
        timeout."""
        import time as _t
        t_end = None if timeout is None else _t.monotonic() + timeout
        with self._cond:
            while self._pending or self._in_flight:
                remaining = None if t_end is None else t_end - _t.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
        return True

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- scoring
    def _run(self):
        """Thread body: `_loop`, and an exception escaping it (outside the
        per-item try) logged once before the thread dies, so that
        `audit_thread_alive` reads 0 at the next scrape."""
        try:
            self._loop()
        except Exception:
            logging.getLogger(__name__).exception(
                "quality auditor thread died; online quality gauges are "
                "FROZEN (audit_thread_alive gauge is now 0)")
            raise

    def _loop(self):
        faults = _faults()
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait()
                if not self._pending:           # stop requested, drained
                    return
                item = self._pending.popleft()
                self._m_backlog.set(len(self._pending))
                self._in_flight = 1
            if faults.ACTIVE is not None:
                # chaos site outside the per-item try: a raise here kills
                # the thread; _in_flight is restored first so that flush()
                # cannot hang on a dead scorer
                try:
                    faults.fire("audit.loop")
                except BaseException:
                    with self._cond:
                        self._in_flight = 0
                        self._cond.notify_all()
                    raise
            try:
                self._score(*item)
            except Exception:
                # an audit failure must never look like a quality pass: it
                # is counted, and serving is unaffected
                self._m_skipped.inc()
            finally:
                with self._cond:
                    self._in_flight = 0
                    self._cond.notify_all()

    def _scoring_stream(self, device):
        """(stream context, stream) for work on `device`: the auditor's own
        CUDA stream on the card, nothing on the CPU."""
        if device.type != "cuda":
            return contextlib.nullcontext(), None
        import torch
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device=device)
        return torch.cuda.stream(self._stream), self._stream

    def _score(self, q, result, k, c, snapshot, ready):
        import torch
        from repro_torch.core import metrics as M
        from repro_torch.core.exact import exact_ranks
        from repro_torch.core.query import smallest_k

        if snapshot is None:
            self._m_skipped.inc()
            return
        users = snapshot.users          # f32 system of record
        ctx, stream = self._scoring_stream(users.device)
        with ctx:
            if ready is not None:
                stream.wait_event(ready)
            try:
                items = snapshot.live_items()
            except ValueError:          # engine built without its item set
                self._m_skipped.inc()
                return
            ranks = exact_ranks(users, items,
                                torch.from_numpy(q).to(users.device))
            # the exact answer from the same ranks: one K3 launch a query
            ex_idx = smallest_k(ranks, k)
            truth, ex_idx = ranks.cpu().numpy(), ex_idx.cpu().numpy()
        got = _np(result.indices)
        ratio = M.overall_ratio(got, ex_idx, truth)
        acc = M.accuracy(got, ex_idx, truth, c)
        # certified slack the selection carries: mean r_up − r_lo over the
        # selected users (backends with full (n,) bounds)
        width = float("nan")
        r_lo, r_up = _np(result.r_lo), _np(result.r_up)
        if r_lo.ndim == 1 and r_lo.shape[0] >= got.max() + 1:
            width = float(np.mean(r_up[got] - r_lo[got]))
        with self._cond:
            self._ratios.append(ratio)
            self._accs.append(acc)
            if np.isfinite(width):
                self._widths.append(width)
            self._m_ratio.set(float(np.mean(self._ratios)))
            self._m_acc.set(float(np.mean(self._accs)))
            if self._widths:
                self._m_width.set(float(np.mean(self._widths)))
        self._m_scored.inc()
