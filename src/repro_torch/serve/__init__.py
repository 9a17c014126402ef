"""Online serving for the port (counterpart of `repro/serve`).

  scheduler — `MicroBatcher`: async `submit(q, k, c) -> Future` requests
              coalesced into `max_batch`-wide `engine.dispatch_batch_at`
              ticks (partial ticks edge-padded), with `max_wait_ms`,
              deadlines, back-pressure, a pipelined completion stage on
              CUDA streams and events, and per-tick stats.
  cache     — `CachingBackend`, registered as `"cached:<inner>"`:
              within-tick dedupe plus a cross-tick per-query LRU.
  faults    — deterministic fault injection at named sites.
  degrade   — `DegradePolicy` / `DegradeController`: the certified
              degrade ladder.

Typical serving stack on the card::

    eng = ReverseKRanksEngine.build(users, items, cfg, 0,
                                    backend="cached:elastic:fused")
    with MicroBatcher(eng, max_batch=16, max_wait_ms=2.0) as mb:
        fut = mb.submit(q, k=10, c=2.0, deadline_ms=50.0)
        res = fut.result(timeout=5.0)      # per-query QueryResult, host
"""
# faults first: stdlib-only, imported by index.snapshot and the engine
from repro_torch.serve import faults
from repro_torch.serve.cache import CachingBackend
from repro_torch.serve.degrade import DegradeController, DegradePolicy
from repro_torch.serve.scheduler import (DeadlineExceeded, MicroBatcher,
                                         QueueFull, REJECT_REASONS,
                                         SchedulerClosed, ServeStats,
                                         TickStats, pad_block)

__all__ = ["CachingBackend", "DeadlineExceeded", "DegradeController",
           "DegradePolicy", "MicroBatcher", "QueueFull", "REJECT_REASONS",
           "SchedulerClosed", "ServeStats", "TickStats", "faults",
           "pad_block"]
