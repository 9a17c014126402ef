"""The port's maintenance loop (`repro_torch.index.maintenance`) against
the reference's (`repro.index.maintenance`).

  * `MaintenancePolicy.trigger` gives the reference's reason strings on a
    grid of `DeltaStats` and measured correction overheads;
  * the loop rebuilds when the policy fires, and the rebuilt table is a
    scratch build with the same seed over the live items; its rebuilds
    spill through an attached persister;
  * after injected `index.rebuild` faults the loop backs off by the
    reference's formula (capped exponential, ±25 % jitter from
    `random.Random(backoff_seed)`), the same waits the reference's loop
    takes for the same seed, and recovers without a restart;
  * a `maintenance.loop` fault kills the thread, and the
    `maintenance_thread_alive` callback gauge reads 0.

Templates: tests/test_index.py:479 and tests/test_faults.py:221, :251.
Every loop is closed in `finally`; every wait is bounded.
"""
import logging
import random
import time

import numpy as np
import pytest
import torch

from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.types import RankTableConfig
from repro_torch.index import (IndexPersister, MaintenanceLoop,
                               MaintenancePolicy)
from repro_torch.index.delta import DeltaStats
from repro_torch.obs import registry as obs
from repro_torch.serve import faults

K, C = 7, 2.0
N, M, D = 256, 128, 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def chaos_hygiene():
    """A fresh default registry and `faults.clear()` around every test,
    so that callback gauges bind to this test's threads."""
    old = obs.get_default()
    obs.set_default(obs.MetricsRegistry())
    try:
        yield
    finally:
        faults.clear()
        obs.set_default(old)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    return (rng.normal(size=(N, D)).astype(np.float32),
            rng.normal(size=(M + 32, D)).astype(np.float32))


def _engine(problem, backend="dense"):
    users, items = problem
    cfg = RankTableConfig(tau=16, omega=4, s=16)
    return ReverseKRanksEngine.build(
        torch.from_numpy(users), torch.from_numpy(items[:M]), cfg, 1,
        backend=backend, device="cpu")


def _wait(cond, timeout=60.0, wake=None):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        if wake is not None:
            wake()
        time.sleep(0.01)
    return cond()


# ---------------------------------------------------------------- policy
def test_trigger_strings_are_the_references():
    from repro.index.delta import DeltaStats as RefStats
    from repro.index.maintenance import MaintenancePolicy as RefPolicy
    policies = [dict(), dict(max_delta_ratio=0.0),
                dict(max_delta_ratio=1.0, max_stale_fraction=0.0),
                dict(max_delta_ratio=1.0, max_stale_fraction=1.0,
                     max_correction_overhead=1.5),
                dict(max_delta_ratio=0.125, max_stale_fraction=0.03125,
                     max_correction_overhead=3.0)]
    seen = set()
    for pol in policies:
        got_p, want_p = MaintenancePolicy(**pol), RefPolicy(**pol)
        for ratio in (0.0, 0.01, 0.05, 0.0500001, 0.3):
            for stale in (0.0, 0.02, 0.0200004, 0.5):
                kw = dict(n_added=3, n_deleted=2, n_dead_users=1,
                          n_touched_users=4, m_base=100, m_live=101,
                          delta_ratio=ratio, stale_weight=stale * 100,
                          stale_fraction=stale)
                for cost in (None, 1.0, 1.5, 2.75, 9.0):
                    got = got_p.trigger(DeltaStats(**kw),
                                        correction_overhead=cost)
                    want = want_p.trigger(RefStats(**kw),
                                          correction_overhead=cost)
                    assert got == want, (pol, ratio, stale, cost)
                    seen.add(None if got is None else got.split()[0])
    assert seen == {None, "delta_ratio", "stale_fraction",
                    "correction_overhead"}


# ------------------------------------------------------------------ loop
def test_maintenance_loop_triggers_rebuild(problem):
    users, items = problem
    eng = _engine(problem)
    ml = MaintenanceLoop(eng, policy=MaintenancePolicy(max_delta_ratio=0.03),
                         poll_ms=5.0)
    try:
        eng.insert_items(torch.from_numpy(items[M:M + 24]))
        ml.wake()
        assert _wait(lambda: bool(ml.rebuilds)), "the loop never rebuilt"
    finally:
        ml.close()
    rec = ml.rebuilds[0]
    assert "delta_ratio" in rec.reason
    assert eng.delta_stats().delta_ratio == 0.0
    assert eng.rank_table.m == M + 24
    reg = obs.get_default()
    assert reg.counter("maintenance_rebuilds_total").value == len(
        ml.rebuilds)
    assert reg.histogram("maintenance_build_ms").count == len(ml.rebuilds)
    # the loop's rebuild is the engine's: a scratch build with the same
    # seed over the live items
    scratch = ReverseKRanksEngine.build(
        torch.from_numpy(users), eng.live_items(), eng.config, 1,
        device="cpu")
    assert torch.equal(eng.rank_table.table, scratch.rank_table.table)
    assert torch.equal(eng.rank_table.thresholds,
                       scratch.rank_table.thresholds)


def test_correction_overhead_policy_probes_the_engine(problem):
    users, items = problem
    eng = _engine(problem)
    ml = MaintenanceLoop(eng, policy=MaintenancePolicy(
        max_delta_ratio=1.0, max_stale_fraction=1.0,
        max_correction_overhead=0.0), poll_ms=5.0)
    try:
        eng.insert_items(torch.from_numpy(items[M:M + 2]))
        ml.wake()
        assert _wait(lambda: bool(ml.rebuilds)), "the loop never rebuilt"
    finally:
        ml.close()
    assert ml.rebuilds[0].reason.startswith("correction_overhead ")


def test_loop_rebuilds_spill_and_restore(tmp_path, problem):
    """Each loop rebuild spills its epoch inside the locked swap: a
    restore after it is bitwise the running engine."""
    users, items = problem
    eng = _engine(problem, backend="fused")
    eng.attach_persister(IndexPersister(tmp_path))
    ml = MaintenanceLoop(eng, policy=MaintenancePolicy(max_delta_ratio=0.1),
                         poll_ms=5.0)
    try:
        eng.insert_items(torch.from_numpy(items[M:M + 16]))
        ml.wake()
        assert _wait(lambda: bool(ml.rebuilds)), "the loop never rebuilt"
    finally:
        ml.close()
    eng.delete_users([3])
    got = ReverseKRanksEngine.restore(tmp_path, backend="fused",
                                      device="cpu")
    assert got.epoch == eng.epoch
    assert torch.equal(got.rank_table.table, eng.rank_table.table)
    qs = torch.from_numpy(items[:4])
    for a, b in zip(got.query_batch(qs, K, C), eng.query_batch(qs, K, C)):
        assert torch.equal(a, b)


def _logged_backoffs(records):
    """The backoff (s) of each logged rebuild failure."""
    return [r.args[2] for r in records
            if r.getMessage().startswith("index rebuild failed")]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_backoff_sequence_is_the_references(problem, caplog):
    """Three injected rebuild failures, then a success: the loop waits
    min(b·2^(i−1), cap)·(1 + 0.25·(2u − 1)) after failure i, u the i-th
    draw of random.Random(seed), exactly the waits the reference's loop
    takes for the same seed and faults, and recovers in the same process
    (the consecutive-failures gauge back to 0, the thread alive)."""
    import jax
    from repro.core.engine import ReverseKRanksEngine as RefEngine
    from repro.core.types import RankTableConfig as RefConfig
    from repro.index.maintenance import MaintenanceLoop as RefLoop
    from repro.index.maintenance import MaintenancePolicy as RefPolicy
    from repro.obs import registry as ref_obs
    from repro.serve import faults as ref_faults
    users, items = problem
    base, cap, seed, fails = 0.01, 0.03, 7, 3
    u = random.Random(seed)
    want = [min(base * 2.0 ** (i - 1), cap) * (1.0 + 0.25 * (
        2.0 * u.random() - 1.0)) for i in range(1, fails + 1)]
    kw = dict(poll_ms=5.0, failure_backoff_s=base, max_backoff_s=cap,
              backoff_seed=seed)
    got = {}
    ref = RefEngine.build(jax.numpy.asarray(users),
                          jax.numpy.asarray(items[:M]),
                          RefConfig(tau=16, omega=4, s=16),
                          jax.random.PRNGKey(1))
    old_ref_reg = ref_obs.get_default()
    ref_obs.set_default(ref_obs.MetricsRegistry())
    for name, eng, loop_cls, policy, flt, new in (
            ("port", _engine(problem), MaintenanceLoop, MaintenancePolicy,
             faults, torch.from_numpy(items[M:M + 8])),
            ("reference", ref, RefLoop, RefPolicy, ref_faults,
             jax.numpy.asarray(items[M:M + 8]))):
        flt.install(flt.FaultPlan(seed=0, rules=[flt.FaultRule(
            "index.rebuild", mode="raise", max_fires=fails)]))
        caplog.clear()
        ml = loop_cls(eng, policy=policy(max_delta_ratio=0.01), **kw)
        try:
            with caplog.at_level(logging.ERROR):
                eng.insert_items(new)
                assert _wait(lambda: bool(ml.rebuilds)
                             and ml.consecutive_failures == 0,
                             wake=ml.wake), f"{name}: never recovered"
            assert len(ml.failures) == fails
            assert all(isinstance(e, flt.InjectedFault)
                       for e in ml.failures)
            assert ml._m_consec.value == 0.0 and ml._thread.is_alive()
        finally:
            ml.close()
            flt.clear()
        got[name] = _logged_backoffs(caplog.records)
    ref_obs.set_default(old_ref_reg)
    assert got["port"] == want
    assert got["reference"] == want


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_maintenance_thread_death_flips_liveness_gauge(problem):
    """A fault OUTSIDE the rebuild's try kills the loop thread; the
    callback gauge reads 0 at the next scrape (no silent death)."""
    eng = _engine(problem)
    faults.install(faults.FaultPlan(seed=0, rules=[
        faults.FaultRule("maintenance.loop", mode="raise", max_fires=1)]))
    ml = MaintenanceLoop(eng, poll_ms=5.0)
    try:
        assert ml._m_alive.value == 1.0
        ml.wake()
        ml._thread.join(timeout=10)
        assert not ml._thread.is_alive()
        assert ml._m_alive.value == 0.0     # scrape-time callback
        assert obs.get_default().gauge(
            "maintenance_thread_alive").value == 0.0
    finally:
        ml.close()
