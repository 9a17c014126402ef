"""Certified degrade ladder: trade answer tightness for survival under
sustained overload, one explicit rung at a time (a port of
`repro/serve/degrade.py`).

Under offered load past the back-pressure knee the scheduler can only
shed (QueueFull) or queue (unbounded latency). The ladder adds a third
option: keep admitting, but serve CHEAPER — and because every rung still
returns certified (r↓, r↑) bounds, the c-approximation contract is
RELAXED EXPLICITLY (the caller can read the served contract off the tick
record and the `serve_degrade_level` gauge), never silently violated.

The rungs (level 0 = normal; each adds to the previous):

  0  normal serving — the configured backend, the submitted c.
  1  backend degrade hook — `QueryBackend.degrade(1)`: the pruned backend
     disables its `max_union_frac` dense-fallback, so a poorly-pruning
     query pays the certified two-phase scan over its kept blocks instead
     of a full-scan latency spike (bimodal p99 is what kills deadline
     SLOs under load). Bounds are unchanged — this rung is free of
     contract cost.
  2  widen the effective approximation: dispatch at c_eff = c · widen_c.
     A looser c admits more of the already-certified candidate set, so
     selection does strictly less bound-tightening work; the result is a
     VALID c_eff-approximation with valid bounds, reported as such
     (`TickStats.degrade_level`, and the auditor is told c_eff so its
     accuracy gauge judges the relaxed contract actually served).
  3  cache-only: answer LRU hits (exact results computed earlier this
     epoch — their certified bounds are as valid as at first compute) and
     SHED misses with `QueueFull` (reason label "degraded"). Requires a
     `CachingBackend` anywhere in the engine's wrapper chain; without one
     the ladder tops out at rung 2.

Hysteresis: stepping reacts to the queue depth observed at each tick cut
against high/low watermarks, and a step (either direction) needs
`dwell_ticks` CONSECUTIVE over/under-watermark ticks — a single bursty
tick cannot thrash the ladder, and recovery (step-up) is as deliberate
as degradation. The current level is exported on the
`serve_degrade_level` gauge.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs import registry as obs


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """Watermarks + hysteresis for the ladder.

    high_depth:  queue depth at tick cut that counts as overloaded.
    low_depth:   depth that counts as recovered (must be < high_depth).
    dwell_ticks: consecutive over/under-watermark ticks required to step.
    max_level:   ladder ceiling (3 = cache-only; 2 when no cache exists).
    widen_c:     the rung-2 contract relaxation factor (c_eff = c · this).
    """

    high_depth: int = 32
    low_depth: int = 4
    dwell_ticks: int = 3
    max_level: int = 3
    widen_c: float = 1.5

    def __post_init__(self):
        if self.low_depth >= self.high_depth:
            raise ValueError(f"low_depth {self.low_depth} must be < "
                             f"high_depth {self.high_depth} (hysteresis)")
        if self.dwell_ticks < 1:
            raise ValueError("dwell_ticks must be >= 1")
        if not 0 <= self.max_level <= 3:
            raise ValueError("max_level must be in [0, 3]")
        if self.widen_c < 1.0:
            raise ValueError("widen_c must be >= 1.0 (a degrade rung "
                             "relaxes the contract, never tightens it)")


def find_cache(backend):
    """The first `CachingBackend` in a wrapper chain (walking `.inner`),
    or None — rung 3 needs its LRU."""
    from repro_torch.serve.cache import CachingBackend
    bk = backend
    while bk is not None:
        if isinstance(bk, CachingBackend):
            return bk
        bk = getattr(bk, "inner", None)
    return None


class DegradeController:
    """Per-scheduler ladder state machine, driven at each tick cut.

    The controller owns the level; the scheduler asks `on_tick_cut(depth)`
    when it forms a tick and adapts its dispatch to the returned level.
    `backend` (optional) receives `degrade(level)` on every level change
    so rung 1 reaches execution; `cache` (optional, auto-discovered from
    the backend chain when omitted) enables rung 3.
    """

    def __init__(self, policy: DegradePolicy = None, *, backend=None,
                 cache=None, registry: Optional[obs.MetricsRegistry] = None):
        self.policy = policy if policy is not None else DegradePolicy()
        self.backend = backend
        self.cache = cache if cache is not None else find_cache(backend)
        self.level = 0
        self._hot = 0           # consecutive ticks at/above high_depth
        self._cool = 0          # consecutive ticks at/below low_depth
        self.transitions: list = []     # (level_from, level_to) history
        reg = registry if registry is not None else obs.get_default()
        self._m_level = reg.gauge(
            "serve_degrade_level",
            "current degrade-ladder rung (0 = normal serving)")
        self._m_steps = reg.counter(
            "serve_degrade_steps_total", "degrade-ladder level changes")
        self._m_level.set(0)

    @property
    def effective_max(self) -> int:
        """Rung 3 needs a cache; without one the ladder tops out at 2."""
        top = self.policy.max_level
        return min(top, 2) if self.cache is None else top

    def widened_c(self, c: float) -> float:
        """The contract actually served at the current level."""
        return c * self.policy.widen_c if self.level >= 2 else c

    def _set_level(self, level: int) -> None:
        if level == self.level:
            return
        self.transitions.append((self.level, level))
        self.level = level
        self._m_level.set(level)
        self._m_steps.inc()
        if self.backend is not None:
            # the backend hook is best-effort: a backend without degrade
            # support must not break the ladder for the scheduler rungs
            try:
                self.backend.degrade(level)
            except Exception:
                pass

    def on_tick_cut(self, depth: int) -> int:
        """Observe the queue depth at a tick cut; returns the level the
        tick must be dispatched at."""
        p = self.policy
        if depth >= p.high_depth:
            self._hot += 1
            self._cool = 0
            if self._hot >= p.dwell_ticks and self.level < self.effective_max:
                self._set_level(self.level + 1)
                self._hot = 0
        elif depth <= p.low_depth:
            self._cool += 1
            self._hot = 0
            if self._cool >= p.dwell_ticks and self.level > 0:
                self._set_level(self.level - 1)
                self._cool = 0
        else:
            # between watermarks: hold the level, reset both dwell counts
            # (the hysteresis band)
            self._hot = 0
            self._cool = 0
        return self.level

    def reset(self) -> None:
        """Back to normal serving (shutdown path)."""
        self._hot = self._cool = 0
        self._set_level(0)
