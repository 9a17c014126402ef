"""Deterministic fault injection for the serving stack (a port of
`repro/serve/faults.py`: the same plans, rules, spec grammar and seeded
per-site streams, so one seed and spec fire the same evaluations).

Chaos testing only works when the chaos is REPRODUCIBLE: a failure a CI
job provokes must be the same failure a developer replays locally. A
`FaultPlan` is a seeded set of rules bound to NAMED SITES in the serving
path; each site draws from its own `random.Random(f"{seed}:{site}")`
stream, so whether (and when) a site fires is a pure function of
(plan seed, per-site evaluation order) — independent of thread
interleaving across sites, wall clock, or which other sites exist.

Sites (the catalog; also ROADMAP "Robustness"):

  ===================  =====================================================
  site                 where it fires
  ===================  =====================================================
  serve.dispatch       inside `MicroBatcher._dispatch`, before the engine
                       call — a raise fails every future of that tick with
                       `InjectedFault` (typed, never torn)
  serve.slow_tick      same place, mode="sleep" — injected dispatch latency
                       (deadline pressure without load)
  serve.transfer       inside the scheduler's COMPLETION stage, before
                       it waits on the tick's device-to-host copy — a
                       raise fails exactly that tick's futures with
                       `InjectedFault` while later in-flight ticks keep
                       completing; mode="sleep" models a slow host
                       read-back (transfer-bound deadline pressure)
  index.rebuild        top of `ReverseKRanksEngine.rebuild` — a failing
                       Algorithm-1 build (exercises the maintenance loop's
                       backoff + recovery)
  index.publish        top of `SnapshotManager.publish` — a hot-swap that
                       dies between build and pointer install
  maintenance.loop     inside `MaintenanceLoop`'s poll iteration, OUTSIDE
                       the rebuild try/except — kills the loop thread (the
                       `maintenance_thread_alive` gauge must flip)
  audit.loop           inside `QualityAuditor`'s scoring loop, OUTSIDE the
                       per-item try/except — kills the auditor thread
  persist.wal_write    inside `IndexPersister.append` — a WAL write error
                       (the engine must keep serving, WAL disabled until
                       the next spill re-baselines)
  persist.spill        inside `IndexPersister.spill` — mode="torn"
                       truncates the spill mid-write (recovery must detect
                       it by checksum, never load it)
  ===================  =====================================================

The port instruments the serve.* and index.* sites; the maintenance,
audit and persist sites belong to modules not ported yet, and stay in
the catalog so that a spec written for the reference parses here too.

Zero-overhead contract
----------------------
Instrumented sites pay exactly ONE module-global flag check when
injection is disabled::

    from repro_torch.serve import faults
    ...
    if faults.ACTIVE is not None:
        faults.fire("serve.dispatch")

`ACTIVE` is `None` unless a plan is installed (`install`), so the
disabled-path cost is an attribute read + `is not None`.

Enabling
--------
Programmatic: ``faults.install(FaultPlan(seed=0, rules=[...]))``. Environment: set ``REPRO_FAULTS`` to a spec
string before the process imports this module, e.g.::

    REPRO_FAULTS="index.rebuild:raise:1.0:2,serve.slow_tick:sleep:0.1::25"
    REPRO_FAULTS_SEED=7

Spec grammar: comma-separated rules ``site:mode[:rate[:max_fires
[:latency_ms]]]`` (empty fields keep defaults). Modes: ``raise`` (raise
`InjectedFault`), ``sleep`` (sleep `latency_ms`), ``torn`` (no raise —
the site itself implements the corruption and asks `should_fire`).
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.obs import registry as obs

# The fault-site catalog (kept in one place so tests and docs cannot
# drift from the instrumented call sites).
SITES = (
    "serve.dispatch",
    "serve.slow_tick",
    "serve.transfer",
    "index.rebuild",
    "index.publish",
    "maintenance.loop",
    "audit.loop",
    "persist.wal_write",
    "persist.spill",
)

_MODES = ("raise", "sleep", "torn")


class InjectedFault(RuntimeError):
    """An error raised by the fault-injection harness (never by real
    code) — chaos tests assert on THIS type so an injected failure can
    never be confused with a genuine bug the test provoked."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site {site!r}")
        self.site = site


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One site's firing rule.

    site:       a name from `SITES` (unknown names are rejected — a typo
                must not silently disable a chaos test).
    mode:       "raise" | "sleep" | "torn" (see module doc).
    rate:       per-evaluation firing probability (1.0 = every time).
    max_fires:  stop firing after this many fires (None = unbounded) —
                "the first two rebuilds fail, then recovery succeeds".
    after:      skip the first `after` evaluations (let warm-up pass).
    latency_ms: sleep duration for mode="sleep".
    """

    site: str
    mode: str = "raise"
    rate: float = 1.0
    max_fires: Optional[int] = None
    after: int = 0
    latency_ms: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"catalog: {list(SITES)}")
        if self.mode not in _MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; "
                             f"one of {list(_MODES)}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1]; got {self.rate}")


class FaultPlan:
    """A seeded, deterministic set of `FaultRule`s.

    Per-site determinism: each site owns a `random.Random(f"{seed}:{site}")`
    stream advanced once per evaluation of that site, so the fire pattern
    at one site does not depend on how often OTHER sites are evaluated —
    the property that makes multi-threaded chaos runs replayable.
    """

    def __init__(self, seed: int = 0, rules: Sequence[FaultRule] = ()):
        self.seed = int(seed)
        self.rules: Dict[str, FaultRule] = {}
        for r in rules:
            if r.site in self.rules:
                raise ValueError(f"duplicate rule for site {r.site!r}")
            self.rules[r.site] = r
        self._lock = threading.Lock()
        self._rngs = {site: random.Random(f"{self.seed}:{site}")
                      for site in self.rules}
        self.evaluations: Dict[str, int] = {s: 0 for s in self.rules}
        self.fires: Dict[str, int] = {s: 0 for s in self.rules}
        self._m_fired = {
            s: obs.get_default().counter(
                "faults_injected_total", "fault-injection site fires",
                labels={"site": s})
            for s in self.rules}

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Build a plan from the ``REPRO_FAULTS`` spec grammar
        (module docstring)."""
        rules: List[FaultRule] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            f = part.split(":")
            if len(f) < 2:
                raise ValueError(
                    f"bad fault spec {part!r}: need site:mode[...]")
            rules.append(FaultRule(
                site=f[0], mode=f[1],
                rate=float(f[2]) if len(f) > 2 and f[2] else 1.0,
                max_fires=(int(f[3]) if len(f) > 3 and f[3] else None),
                latency_ms=(float(f[4]) if len(f) > 4 and f[4] else 0.0)))
        return cls(seed=seed, rules=rules)

    def _evaluate(self, site: str) -> Optional[FaultRule]:
        """Advance the site's stream; the rule when it fires, else None."""
        rule = self.rules.get(site)
        if rule is None:
            return None
        with self._lock:
            n = self.evaluations[site]
            self.evaluations[site] = n + 1
            if n < rule.after:
                return None
            if rule.max_fires is not None and \
                    self.fires[site] >= rule.max_fires:
                return None
            draw = self._rngs[site].random()
            if draw >= rule.rate:
                return None
            self.fires[site] += 1
        self._m_fired[site].inc()
        return rule


# The module-global plan — `None` means injection is OFF, and every
# instrumented site's disabled-path cost is the one `is not None` check.
ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Install `plan` process-wide (replacing any previous plan)."""
    global ACTIVE
    ACTIVE = plan
    return plan


def clear() -> None:
    """Disable injection (restores the zero-overhead path)."""
    global ACTIVE
    ACTIVE = None


def fire(site: str) -> None:
    """Evaluate `site` against the active plan: raise `InjectedFault`
    (mode="raise"), sleep (mode="sleep"), or do nothing. Call sites gate
    on ``faults.ACTIVE is not None`` FIRST — this function is never on
    the disabled path."""
    plan = ACTIVE
    if plan is None:
        return
    rule = plan._evaluate(site)
    if rule is None:
        return
    if rule.mode == "sleep":
        time.sleep(rule.latency_ms / 1e3)
        return
    if rule.mode == "raise":
        raise InjectedFault(site)
    # mode="torn": the site asks `should_fire` instead; reaching here
    # through fire() is a plan-authoring error — treat as no-op.


def should_fire(site: str) -> bool:
    """Evaluate `site` and report whether it fired, WITHOUT raising —
    for sites that implement the failure themselves (torn spill files,
    WAL write errors where the caller owns the corruption)."""
    plan = ACTIVE
    if plan is None:
        return False
    return plan._evaluate(site) is not None


def _install_from_env() -> None:
    spec = os.environ.get("REPRO_FAULTS")
    if spec:
        install(FaultPlan.parse(
            spec, seed=int(os.environ.get("REPRO_FAULTS_SEED", "0"))))


_install_from_env()
