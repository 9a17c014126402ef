"""Background index maintenance: the rebuild policy and an off-thread
rebuild with hot-swap (counterpart of `repro/index/maintenance.py`).

The delta buffer keeps queries exact in expectation while it is small;
past a point the per-query correction cost and the tombstoned-sample
noise grow without bound. `MaintenanceLoop` watches the engine's
`DeltaStats` and, when the policy triggers, runs `engine.rebuild` (a full
Algorithm 1 on the engine's backend, K2 on the card) off the serving
threads, which hot-swaps the new epoch through the snapshot manager.
Queries keep running against the old snapshot until the swap's single
reference assignment, and mutations that land while the rebuild runs are
re-based onto the new epoch during the swap.

Policy knobs:

  max_delta_ratio    — rebuild when (inserts + deletes) / m_base exceeds
                       it: the correction's cost and its clamp slack
                       grow with that ratio.
  max_stale_fraction — rebuild when the tombstoned sample weight (Eq. (1)
                       mass of samples whose item no longer exists)
                       exceeds this fraction of m_base: the rank-error
                       budget.
  max_correction_overhead — rebuild when the measured cost of the delta
                       correction (`engine.correction_overhead()`, the
                       ratio of a corrected to a static query on this
                       engine's backend, synchronized with the card)
                       exceeds it. inf disables the probe.
  compact_dead_above — passed to `engine.rebuild(compact_dead_above=)`:
                       past this deleted-user fraction, dead rows are
                       compacted out and the old→new map published.
  reorder_clusters   — passed to `engine.rebuild(reorder_clusters=)`:
                       each rebuild re-clusters the users so the pruned
                       backend's tiles stay tight; the permutation
                       composes onto the lineage's `user_remap` under the
                       same swap.
  min_interval_s     — floor between rebuilds, so that a mutation storm
                       cannot wedge the loop into back-to-back builds.

`RebuildRecord` is what `ReverseKRanksEngine.rebuild` returns.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import List, Optional

from repro_torch.index.delta import DeltaStats
from repro_torch.obs import registry as obs
from repro_torch.obs import trace
from repro_torch.serve import faults


@dataclasses.dataclass(frozen=True)
class MaintenancePolicy:
    max_delta_ratio: float = 0.05
    max_stale_fraction: float = 0.02
    max_correction_overhead: float = float("inf")
    compact_dead_above: Optional[float] = None
    reorder_clusters: bool = False
    min_interval_s: float = 0.0

    def trigger(self, stats: DeltaStats,
                correction_overhead: Optional[float] = None
                ) -> Optional[str]:
        """The reason a rebuild is due, or None. `correction_overhead` is
        the measured delta/static query cost ratio (None when the caller
        did not probe it)."""
        if stats.delta_ratio > self.max_delta_ratio:
            return (f"delta_ratio {stats.delta_ratio:.4f} > "
                    f"{self.max_delta_ratio}")
        if stats.stale_fraction > self.max_stale_fraction:
            return (f"stale_fraction {stats.stale_fraction:.4f} > "
                    f"{self.max_stale_fraction}")
        if (correction_overhead is not None
                and correction_overhead > self.max_correction_overhead):
            return (f"correction_overhead {correction_overhead:.2f}x > "
                    f"{self.max_correction_overhead}x")
        return None


@dataclasses.dataclass(frozen=True)
class RebuildRecord:
    """One completed rebuild and swap, as the engine observed it."""

    epoch_before: int       # snapshot the rebuild was captured from
    epoch_after: int        # epoch published by the swap
    reason: str
    build_s: float          # Algorithm 1 wall time, off the mutation lock
    swap_s: float           # re-base, publish (and spill) time, under it
    stats: DeltaStats       # delta accounting at capture time
    users_compacted: int = 0        # deleted rows the swap dropped
    users_reordered: bool = False   # the swap published a cluster reorder


class MaintenanceLoop:
    """Poll `engine.delta_stats()` and rebuild when the policy triggers.

    Usage::

        with MaintenanceLoop(eng, policy=MaintenancePolicy(0.05)) as ml:
            ...     # the engine serves; inserts and deletes stream in
        print(ml.rebuilds)          # [RebuildRecord, ...]

    One daemon thread; `wake()` forces a policy check now. `close()`
    stops the loop; a rebuild in flight completes its swap.

    A failing rebuild must not kill the thread: its exception is logged,
    appended to `failures` (the last `_MAX_FAILURES`), and the loop keeps
    polling. After a failure the next attempt waits a capped exponential
    backoff with jitter, `failure_backoff_s · 2^(consecutive−1)` up to
    `max_backoff_s`, times 1 ± 25 % from `random.Random(backoff_seed)`,
    so that a persistently failing build is not retried every poll and a
    fleet of loops does not retry in lockstep. `consecutive_failures`
    returns to 0 on the first success and is exported as the
    `maintenance_consecutive_failures` gauge beside
    `maintenance_last_failure_unixtime`.

    Liveness: the `maintenance_thread_alive` callback gauge reads
    `thread.is_alive()` at scrape time, for the one failure the loop
    cannot report itself (an exception outside the rebuild's try, which
    kills the thread after `_run` logs it once).
    """

    _MAX_FAILURES = 32

    def __init__(self, engine, *, policy: MaintenancePolicy = None,
                 poll_ms: float = 50.0, failure_backoff_s: float = 5.0,
                 max_backoff_s: float = 60.0, backoff_seed: int = 0):
        self.engine = engine
        self.policy = policy if policy is not None else MaintenancePolicy()
        self.poll_ms = float(poll_ms)
        self.failure_backoff_s = float(failure_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.rebuilds: List[RebuildRecord] = []
        self.failures: List[BaseException] = []
        self.consecutive_failures = 0
        self._jitter = random.Random(backoff_seed)
        reg = obs.get_default()
        self._m_rebuilds = reg.counter(
            "maintenance_rebuilds_total", "completed rebuild + hot-swaps")
        self._m_failures = reg.counter(
            "maintenance_failures_total", "rebuild attempts that raised")
        self._m_build = reg.histogram(
            "maintenance_build_ms", "off-lock Algorithm 1 wall time")
        self._m_swap = reg.histogram(
            "maintenance_swap_ms", "under-lock re-base + publish time")
        self._m_delta = reg.gauge(
            "maintenance_delta_ratio", "|delta|/m at the last poll")
        self._m_stale = reg.gauge(
            "maintenance_stale_fraction",
            "tombstoned sample weight fraction at the last poll")
        self._m_consec = reg.gauge(
            "maintenance_consecutive_failures",
            "rebuild failures since the last success (0 = healthy)")
        self._m_last_fail = reg.gauge(
            "maintenance_last_failure_unixtime",
            "wall-clock time of the last rebuild failure (0 = never)")
        self._backoff_until = -float("inf")
        self._cond = threading.Condition()
        self._stop = False
        self._last_rebuild_t = -float("inf")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="index-maintenance")
        # liveness read at scrape time: a dead thread cannot leave a
        # stale "alive" value behind in a callback gauge
        self._m_alive = reg.gauge(
            "maintenance_thread_alive",
            "1 while the maintenance loop thread is running",
            set_fn=self._thread.is_alive)
        self._thread.start()

    def wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _run(self):
        """Thread body: `_loop`, and an exception escaping it (raised
        outside the rebuild's try) logged once before the thread dies, so
        that `maintenance_thread_alive` reads 0 at the next scrape."""
        try:
            self._loop()
        except Exception:
            logging.getLogger(__name__).exception(
                "maintenance loop thread died; rebuilds have STOPPED "
                "(maintenance_thread_alive gauge is now 0)")
            raise

    def _loop(self):
        while True:
            with self._cond:
                if self._stop:
                    return
                self._cond.wait(timeout=self.poll_ms / 1e3)
                if self._stop:
                    return
            if faults.ACTIVE is not None:
                # chaos site OUTSIDE the rebuild's try: a raise here kills
                # the thread, which the liveness gauge must show
                faults.fire("maintenance.loop")
            now = time.monotonic()
            if (now - self._last_rebuild_t < self.policy.min_interval_s
                    or now < self._backoff_until):
                continue
            cost = None
            if self.policy.max_correction_overhead != float("inf"):
                # measured at decision time on the serving backend (cached
                # per correction shape, so cheap per poll)
                cost = self.engine.correction_overhead()
            stats = self.engine.delta_stats()
            self._m_delta.set(stats.delta_ratio)
            self._m_stale.set(stats.stale_fraction)
            reason = self.policy.trigger(stats, correction_overhead=cost)
            if reason is None:
                continue
            try:
                with trace.span("maintenance.rebuild", reason=reason):
                    record = self.engine.rebuild(
                        reason=reason,
                        compact_dead_above=self.policy.compact_dead_above,
                        reorder_clusters=self.policy.reorder_clusters)
            except Exception as e:      # keep maintaining; surface it
                self.failures.append(e)
                del self.failures[:-self._MAX_FAILURES]
                self.consecutive_failures += 1
                self._m_failures.inc()
                self._m_consec.set(self.consecutive_failures)
                self._m_last_fail.set(time.time())
                # capped exponential backoff with ±25% jitter: doubles
                # per consecutive failure, capped so that recovery after
                # a long outage is not deferred for minutes, jittered so
                # that replicas sharing a failing dependency do not retry
                # in lockstep
                backoff = min(
                    self.failure_backoff_s
                    * 2.0 ** (self.consecutive_failures - 1),
                    self.max_backoff_s)
                backoff *= 1.0 + 0.25 * (2.0 * self._jitter.random() - 1.0)
                self._backoff_until = time.monotonic() + backoff
                logging.getLogger(__name__).exception(
                    "index rebuild failed (%s; failure #%d in a row); "
                    "maintenance loop continues after %.1fs backoff",
                    reason, self.consecutive_failures, backoff)
                record = None
            self._last_rebuild_t = time.monotonic()
            if record is not None:
                if self.consecutive_failures:
                    # recovery: the health gauge returns to 0 without a
                    # process restart
                    self.consecutive_failures = 0
                    self._m_consec.set(0)
                self.rebuilds.append(record)
                self._m_rebuilds.inc()
                self._m_build.observe(record.build_s * 1e3)
                self._m_swap.observe(record.swap_s * 1e3)
