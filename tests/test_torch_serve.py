"""The port's serving stack (`repro_torch.serve`: `MicroBatcher`,
`CachingBackend`, faults, the degrade ladder; the engine's
`dispatch_batch_at` and the backends' `dispatch_device` and `degrade`)
on the CPU, against the JAX reference where the reference computes the
same thing: `pad_block`, the cache's key bytes, `FaultPlan` decisions for
a seed and spec, and `DegradeController` rungs over a sequence of queue
depths. Results served through the scheduler are held bitwise against
the port engine's direct `query_batch` (integer inputs, so every score
is exact at any batch width).

Templates: tests/test_serve.py and tests/test_faults.py. Left out: the
sharded inner (`cached:sharded`, not ported), the maintenance-loop and
auditor cases (their modules are not ported) and the hypothesis property
(no Hypothesis in the port's tests). The overlap tests slow the
completion stage with the `serve.transfer` sleep fault instead of the
reference's slow-readback fake, since the port's completion stage waits
on a CUDA event, not on a host read of the result.

Hygiene: two intra-op threads; every MicroBatcher is closed (a `with`
block or `finally`); every wait is bounded.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import cache as ref_cache
from repro.serve import degrade as ref_degrade
from repro.serve import faults as ref_faults
from repro.serve import scheduler as ref_scheduler
from repro_torch.core.backends import get_backend
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.types import QueryResult, RankTableConfig
from repro_torch.obs import registry as obs
from repro_torch.serve import (CachingBackend, DeadlineExceeded,
                               DegradeController, DegradePolicy,
                               MicroBatcher, QueueFull, SchedulerClosed,
                               faults, pad_block)
from repro_torch.serve import scheduler as sched_mod

K, C = 7, 2.0
MAX_BATCH = 4
N, M, D = 400, 120, 12
BACKENDS = ("dense", "fused", "elastic:dense", "elastic:fused",
            "cached:dense", "cached:elastic:fused", "pruned:dense")
WAIT = 60                                   # every future's bound, s


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _chaos_hygiene():
    """A fresh default registry and no fault plan after every test."""
    old = obs.get_default()
    obs.set_default(obs.MetricsRegistry())
    try:
        yield
    finally:
        faults.clear()
        obs.set_default(old)


def int_problem(seed=0, n=N, m=M, d=D):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(-4, 5, (n, d)).astype(np.float32)),
            torch.from_numpy(rng.integers(-4, 5, (m, d)).astype(np.float32)))


@pytest.fixture(scope="module")
def problem():
    return int_problem()


def _cfg(spec="f32"):
    return RankTableConfig(tau=16, omega=4, s=8, storage_dtype=spec)


def _engine(problem, backend="dense", spec="f32"):
    users, items = problem
    return ReverseKRanksEngine.build(users, items, _cfg(spec), 0,
                                     backend=backend, device="cpu")


def _queries(problem, b, step=7):
    return problem[1][(1 + torch.arange(b) * step) % M]


def assert_bitwise(got, want):
    for f in QueryResult._fields:
        x, y = getattr(got, f), getattr(want, f)
        assert x.shape == y.shape and torch.equal(x, y), f


def _row(res, i):
    return QueryResult(*(x[i] for x in res))


def _serve(eng, qs, **kw):
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("max_wait_ms", 25.0)
    with MicroBatcher(eng, **kw) as mb:
        futs = [mb.submit(q, K, C) for q in qs]
        out = [f.result(timeout=WAIT) for f in futs]
    return out, mb


# ------------------------------------------------------------- scheduler
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("size", [1, 2, 3, MAX_BATCH])
def test_partial_tick_is_bitwise_direct(problem, backend, size):
    """A partial tick, edge-padded to max_batch, serves each query
    bitwise the engine's direct query_batch of the unpadded block; host
    results on the CPU."""
    eng = _engine(problem, backend)
    qs = _queries(problem, size)
    direct = eng.query_batch(qs, K, C)
    got, _ = _serve(eng, qs.numpy())
    for i, r in enumerate(got):
        assert r.indices.device.type == "cpu"
        assert_bitwise(r, _row(direct, i))


@pytest.mark.parametrize("depth", [1, 2])
def test_results_own_their_memory(problem, depth):
    """Each served result owns its row: no two results of a tick share
    storage, and a result's storage holds its own bytes and no more, so
    a held result keeps nothing of its tick alive."""
    eng = _engine(problem, "elastic:fused")
    got, _ = _serve(eng, _queries(problem, MAX_BATCH).numpy(),
                    pipeline_depth=depth)
    ptrs = set()
    for r in got:
        for x in r:
            storage = x.untyped_storage()
            assert storage.nbytes() == x.numel() * x.element_size()
            ptrs.add(storage.data_ptr())
    assert len(ptrs) == len(got) * len(QueryResult._fields)


def test_pad_block_matches_the_reference(problem):
    qs = _queries(problem, 3)
    for mb in (3, 4, 9):
        got = pad_block(qs, mb)
        want = ref_scheduler.pad_block(jnp.asarray(qs.numpy()), mb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for bad, width, msg in ((qs[:1], 1, "max_batch must be >= 2"),
                            (qs[:0], 4, "does not fit"),
                            (qs, 2, "does not fit")):
        with pytest.raises(ValueError, match=msg):
            pad_block(bad, width)


def test_scheduler_coalesces_and_reports(problem):
    eng = _engine(problem)
    qs = _queries(problem, 2 * MAX_BATCH + 1)
    got, mb = _serve(eng, qs.numpy(), max_wait_ms=50.0)
    direct = eng.query_batch(qs, K, C)
    for i, r in enumerate(got):
        assert_bitwise(r, _row(direct, i))
    st, log = mb.stats(), mb.tick_log
    assert st.requests == len(qs) and st.ticks == len(log) >= 3
    assert sum(t.batch for t in log) == len(qs)
    assert all(0 < t.fill_ratio <= 1 for t in log)
    assert st.p50_ms <= st.p99_ms
    assert all(t.copy_bytes > 0 and t.copy_ms == 0.0 for t in log)
    log.clear()
    assert len(mb.tick_log) == st.ticks        # tick_log returns a copy


def test_scheduler_separates_static_args(problem):
    eng = _engine(problem)
    qs = _queries(problem, 4).numpy()
    with MicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=30.0) as mb:
        f1 = [mb.submit(q, K, C) for q in qs[:2]]
        f2 = [mb.submit(q, K + 1, C) for q in qs[2:]]
        r1 = [f.result(timeout=WAIT) for f in f1]
        r2 = [f.result(timeout=WAIT) for f in f2]
    assert all(r.indices.shape == (K,) for r in r1)
    assert all(r.indices.shape == (K + 1,) for r in r2)
    assert len(mb.tick_log) >= 2


def test_full_group_preempts_straggler_head(problem):
    eng = _engine(problem)
    qs = _queries(problem, MAX_BATCH + 1).numpy()
    with MicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=5_000.0) as mb:
        head = mb.submit(qs[0], K + 2, C)
        t0 = time.monotonic()
        full = [mb.submit(q, K, C) for q in qs[1:]]
        for f in full:
            f.result(timeout=WAIT)
        fast = time.monotonic() - t0
        mb.flush()
        head.result(timeout=WAIT)
    assert fast < 4.0                           # did not wait out the head


class _FailingEngine:
    """query_batch always raises: the dispatch error path."""

    def query_batch(self, qs, *, k, c):
        raise RuntimeError("induced dispatch failure")


def test_error_propagates_and_close_flushes_the_terminal_tick():
    mb = MicroBatcher(_FailingEngine(), max_batch=2, max_wait_ms=60_000.0,
                      max_depth=1)
    try:
        fut = mb.submit(np.zeros(4, np.float32), K, C)
        with pytest.raises(QueueFull):
            mb.submit(np.ones(4, np.float32), K, C)
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="induced dispatch failure"):
        fut.result(timeout=WAIT)
    log = mb.tick_log
    assert len(log) == 1 and log[0].batch == 0 and log[0].rejected == 1
    st = mb.stats()
    assert st.rejected == 1 and st.requests == 0 and st.p99_ms == 0.0


def test_microbatcher_rejects_bad_knobs(problem):
    eng = _engine(problem)
    for kw, msg in ((dict(max_batch=1), "max_batch must be >= 2"),
                    (dict(pipeline_depth=0), "pipeline_depth"),
                    (dict(max_wait_ms=-1.0), "max_wait_ms"),
                    (dict(max_depth=0), "max_depth")):
        with pytest.raises(ValueError, match=msg):
            MicroBatcher(eng, **kw)
    got, _ = _serve(eng, _queries(problem, 1).numpy(), max_batch=2)
    assert got[0].indices.shape == (K,)


def test_tick_compiles_flat_after_warm_up(problem):
    """TickStats.compiles samples the elastic program count around each
    dispatch: the warm-up tick of a fresh k builds one, later ticks none."""
    eng = _engine(problem, "elastic:dense")
    qs = _queries(problem, MAX_BATCH).numpy()
    k_fresh = K + 3
    with MicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=200.0) as mb:
        for _ in range(2):
            for f in [mb.submit(q, k_fresh, C) for q in qs]:
                f.result(timeout=WAIT)
    log = mb.tick_log
    assert [t.compiles for t in log] == [1, 0]
    assert obs.get_default().counter("serve_compiles_total").value == 1.0


# ------------------------------------------------------------------ cache
@pytest.mark.parametrize("backend", ("dense", "fused", "elastic:dense",
                                     "elastic:fused", "pruned:dense"))
def test_cached_is_bitwise_uncached(problem, backend):
    users, items = problem
    eng = _engine(problem, backend)
    cached = CachingBackend(eng._backend)
    rt, su = eng.rank_table, eng.current_snapshot().query_users()
    qs = torch.cat([_queries(problem, 3), _queries(problem, 2)])  # dupes
    want = eng._backend.query_batch(rt, su, qs, k=K, c=C)
    assert_bitwise(cached.query_batch(rt, su, qs, k=K, c=C), want)
    # within a tick duplicates are deduped, not hits: 3 rows dispatched
    assert (cached.misses, cached.hits, len(cached._lru)) == (5, 0, 3)
    assert_bitwise(cached.query_batch(rt, su, qs, k=K, c=C), want)
    assert cached.hits == 5
    one = cached.query_batch(rt, su, qs[:1], k=K, c=C)
    assert_bitwise(one, eng._backend.query_batch(rt, su, qs[:1], k=K, c=C))
    assert_bitwise(cached.dispatch_device(rt, su, qs.numpy(), k=K, c=C),
                   want)


def test_cached_keyed_by_k_and_c(problem):
    eng = _engine(problem)
    cached = CachingBackend("dense")
    rt, u = eng.rank_table, eng.users
    qs = _queries(problem, 2)
    cached.query_batch(rt, u, qs, k=K, c=C)
    cached.query_batch(rt, u, qs, k=K + 1, c=C)
    cached.query_batch(rt, u, qs, k=K, c=1.3)
    assert cached.misses == 6 and cached.hits == 0
    cached.query_batch(rt, u, qs, k=K, c=1.3)
    assert cached.hits == 2


def test_cached_lru_eviction_and_invalidation(problem):
    eng = _engine(problem, "cached:dense")
    cached = eng._backend
    cached.capacity = 3
    qs = _queries(problem, 5)
    eng.query_batch(qs, K, C)
    assert len(cached._lru) == 3 and cached.evictions == 2
    eng.query_batch(qs[-1:], K, C)
    assert cached.hits == 1
    eng.insert_items(problem[1][:2] * 2)        # a new generation
    res = eng.query_batch(qs[-1:], K, C)
    assert cached.hits == 1 and len(cached._lru) == 1
    assert_bitwise(res, get_backend("dense").query_batch(
        eng.rank_table, eng.users, qs[-1:], k=K, c=C,
        delta=eng.current_snapshot().corr))


def test_cache_key_bytes_match_the_reference():
    """One key per semantically equal row (−0.0 and +0.0, NaN payloads),
    and the same key bytes as the reference's for the same row, in the
    raw and the quantized key paths."""
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal(8).astype(np.float32) for _ in range(4)]
    a = np.linspace(-1.0, 1.0, 8).astype(np.float32)
    a[0] = 0.0
    b = a.copy()
    b[0] = -0.0
    n1, n2 = a.copy(), a.copy()
    n1.view(np.uint32)[1] = np.uint32(0x7FC00001)
    n2.view(np.uint32)[1] = np.uint32(0xFFC00000)
    z1, z2 = np.zeros(8, np.float32), np.full(8, -0.0, np.float32)
    rows += [a, b, n1, n2, z1, z2, np.full(8, np.inf, np.float32)]
    for bits in (None, 8, 3):
        port = CachingBackend("dense", quantize_key_bits=bits)
        ref = ref_cache.CachingBackend("dense", quantize_key_bits=bits)
        for r in rows:
            keep = r.tobytes()
            assert port._key_bytes(r) == ref._key_bytes(r)
            assert r.tobytes() == keep          # the caller's row untouched
            np.testing.assert_array_equal(
                ref_cache._canonical_key_row(r).view(np.uint32),
                sched_canonical(r).view(np.uint32))
        assert port._key_bytes(a) == port._key_bytes(b)
        assert port._key_bytes(n1) == port._key_bytes(n2)
        assert port._key_bytes(z1) == port._key_bytes(z2)


def sched_canonical(row):
    from repro_torch.serve.cache import _canonical_key_row
    return _canonical_key_row(row)


def test_cache_hits_on_negzero_requery(problem):
    eng = _engine(problem)
    cached = CachingBackend("dense")
    q1 = _queries(problem, 1).clone()
    q1[0, 0] = 0.0
    q2 = q1.clone()
    q2[0, 0] = -0.0
    r1 = cached.query_batch(eng.rank_table, eng.users, q1, k=K, c=C)
    r2 = cached.query_batch(eng.rank_table, eng.users, q2, k=K, c=C)
    assert (cached.misses, cached.hits) == (1, 1)
    assert_bitwise(r2, r1)


def test_wrapper_resolution(problem):
    with pytest.raises(ValueError, match="unknown query backend"):
        get_backend("cached:no-such-backend")
    with pytest.raises(ValueError, match="unknown backend wrapper"):
        get_backend("nope:dense")
    for spec in ("cached:dense", "cached:elastic:fused", "elastic:fused",
                 "cached:pruned:dense"):
        assert get_backend(spec).name == spec
    eng = _engine(problem, "cached:elastic:dense")
    assert eng.backend_name == "cached:elastic:dense"
    assert eng.query(_queries(problem, 1)[0], K, C).indices.shape == (K,)


def test_degrade_reaches_the_execution_backend(problem):
    bk = get_backend("cached:elastic:pruned:dense")
    pruned = bk.inner.inner
    bk.degrade(1)
    assert pruned._degrade_level == 1 and bk.inner._degrade_level == 1
    users, items = problem
    eng = ReverseKRanksEngine.build(users, items, _cfg(), 0, device="cpu",
                                    backend="pruned:dense")
    pr = eng._backend
    pr.max_union_frac = 0.0                     # every query falls back
    qs = _queries(problem, 3)
    want = eng.query_batch(qs, K, C)
    assert pr.stats.fallback == "dense"
    pr.degrade(1)                               # rung 1: no fallback
    assert_bitwise(eng.query_batch(qs, K, C), want)
    assert pr.stats.fallback == ""
    pr.degrade(0)
    eng.query_batch(qs, K, C)
    assert pr.stats.fallback == "dense"


# --------------------------------------------------------------- pipeline
@pytest.mark.parametrize("backend", ("dense", "elastic:fused",
                                     "cached:elastic:dense"))
@pytest.mark.parametrize("spec", ("f32", "int8"))
@pytest.mark.parametrize("size", [3, 2 * MAX_BATCH + 3])
def test_pipelined_vs_sync_bit_identity(problem, backend, spec, size):
    eng = _engine(problem, backend, spec)
    qs = _queries(problem, size)
    direct = eng.query_batch(qs, K, C)
    piped, _ = _serve(eng, qs.numpy(), pipeline_depth=2)
    sync, _ = _serve(eng, qs.numpy(), pipeline_depth=1)
    for i, (p, s) in enumerate(zip(piped, sync)):
        assert_bitwise(p, _row(direct, i))
        assert_bitwise(p, s)


class _EchoEngine:
    """Duck engine echoing the query block, so that each result names its
    query."""

    def __init__(self):
        from typing import NamedTuple

        class Echo(NamedTuple):
            rows: torch.Tensor
        self.Echo = Echo

    def query_batch(self, qs, *, k, c):
        return self.Echo(qs.clone())


def _slow_transfer(ms):
    faults.install(faults.FaultPlan(seed=0, rules=[
        faults.FaultRule("serve.transfer", mode="sleep", rate=1.0,
                         latency_ms=ms)]))


def test_pipeline_overlaps_ticks_and_bounds_inflight():
    qs = np.random.default_rng(0).standard_normal(
        (4 * MAX_BATCH, 8)).astype(np.float32)

    def run(depth):
        _slow_transfer(30.0)
        try:
            with MicroBatcher(_EchoEngine(), max_batch=MAX_BATCH,
                              max_wait_ms=1.0, pipeline_depth=depth) as mb:
                futs = [mb.submit(q, K, C) for q in qs]
                for i, f in enumerate(futs):
                    np.testing.assert_array_equal(
                        f.result(timeout=WAIT).rows.numpy(), qs[i])
        finally:
            faults.clear()
        return mb.tick_log, mb.stats()

    log2, st2 = run(2)
    assert max(t.inflight for t in log2) == 2 and st2.overlap_efficiency > 0
    log1, st1 = run(1)
    assert max(t.inflight for t in log1) == 1
    assert st1.overlap_efficiency == 0.0


def test_futures_resolve_in_dispatch_order():
    qs = np.random.default_rng(1).standard_normal(
        (3 * MAX_BATCH, 8)).astype(np.float32)
    order: list = []
    _slow_transfer(20.0)
    with MicroBatcher(_EchoEngine(), max_batch=MAX_BATCH, max_wait_ms=1.0,
                      pipeline_depth=3) as mb:
        futs = []
        for i, q in enumerate(qs):
            f = mb.submit(q, K, C)
            f.add_done_callback(lambda _, i=i: order.append(i))
            futs.append(f)
        for f in futs:
            f.result(timeout=WAIT)
    assert order == sorted(order)


def test_deadline_under_overlap_only_sheds_undispatched():
    qs = np.random.default_rng(2).standard_normal(
        (MAX_BATCH + 1, 8)).astype(np.float32)
    _slow_transfer(50.0)
    with MicroBatcher(_EchoEngine(), max_batch=MAX_BATCH, max_wait_ms=1.0,
                      pipeline_depth=1) as mb:
        committed = [mb.submit(q, K, C, deadline_ms=20.0)
                     for q in qs[:MAX_BATCH]]
        doomed = mb.submit(qs[-1], K, C, deadline_ms=10.0)
        for i, f in enumerate(committed):
            np.testing.assert_array_equal(
                f.result(timeout=WAIT).rows.numpy(), qs[i])
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=WAIT)
    assert mb.stats().expired == 1
    assert sum(t.expired for t in mb.tick_log) == 1


def test_admission_hit_resolves_without_tick(problem):
    eng = _engine(problem, "cached:elastic:fused")
    hot = _queries(problem, 1)[0]
    want = eng.query(hot, K, C)
    with MicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=5.0) as mb:
        got = mb.submit(hot.numpy(), K, C).result(timeout=WAIT)
        st = mb.stats()
    assert_bitwise(got, want)
    assert st.admission_hits == 1 and st.requests == 1
    assert mb.tick_log == []
    assert obs.get_default().counter("serve_admission_hits_total").value == 1


def test_admission_miss_takes_the_normal_path(problem):
    eng = _engine(problem, "cached:dense")
    q = _queries(problem, 1)[0].numpy()
    with MicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=5.0) as mb:
        first = mb.submit(q, K, C).result(timeout=WAIT)
        mb.flush()
        second = mb.submit(q, K, C).result(timeout=WAIT)
        st = mb.stats()
    assert_bitwise(second, first)
    assert st.admission_hits == 1 and st.requests == 2
    assert sum(t.batch for t in mb.tick_log) == 1


def test_dispatch_device_is_query_batch(problem):
    """The serving entry (host block in, device tensors out) is bitwise
    query_batch on every backend, through the engine."""
    for backend in BACKENDS:
        eng = _engine(problem, backend)
        qs = _queries(problem, 3)
        snap = eng.current_snapshot()
        assert_bitwise(eng.dispatch_batch_at(snap, qs.numpy(), K, C),
                       eng.query_batch_at(snap, qs, K, C))


# ---------------------------------------------------------------- faults
def _decisions(mod, seed, rules, evals=64, noise=0):
    mod.install(mod.FaultPlan(seed=seed, rules=rules))
    out = []
    try:
        for i in range(evals):
            for _ in range(noise * (i % 3)):
                mod.should_fire("serve.slow_tick")
            out.append(mod.should_fire("serve.dispatch"))
    finally:
        mod.clear()
    return out


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_fault_plan_decisions_match_the_reference(seed):
    def rules(mod):
        return [mod.FaultRule("serve.dispatch", mode="raise", rate=0.3,
                              after=2, max_fires=9),
                mod.FaultRule("serve.slow_tick", mode="sleep", rate=0.5)]

    got = _decisions(faults, seed, rules(faults))
    assert got == _decisions(ref_faults, seed, rules(ref_faults))
    assert got == _decisions(faults, seed, rules(faults), noise=5)
    assert any(got) and not all(got)


def test_fault_spec_parse_matches_the_reference(monkeypatch):
    spec = "index.rebuild:raise:1.0:2, serve.slow_tick:sleep:0.1::25"
    got, want = faults.FaultPlan.parse(spec, 7), \
        ref_faults.FaultPlan.parse(spec, 7)
    assert got.seed == want.seed == 7
    for site, r in want.rules.items():
        g = got.rules[site]
        assert (g.mode, g.rate, g.max_fires, g.after, g.latency_ms) == \
            (r.mode, r.rate, r.max_fires, r.after, r.latency_ms)
    assert faults.SITES == ref_faults.SITES
    monkeypatch.setenv("REPRO_FAULTS", "serve.dispatch:raise:0.5")
    monkeypatch.setenv("REPRO_FAULTS_SEED", "11")
    faults._install_from_env()
    try:
        got = [faults.should_fire("serve.dispatch") for _ in range(32)]
    finally:
        faults.clear()
    ref_faults._install_from_env()
    try:
        want = [ref_faults.should_fire("serve.dispatch") for _ in range(32)]
    finally:
        ref_faults.clear()
    assert got == want


def test_fault_plan_rejects_typos_and_counts():
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultRule("serve.dispach")
    with pytest.raises(ValueError, match="unknown fault mode"):
        faults.FaultRule("serve.dispatch", mode="explode")
    with pytest.raises(ValueError, match="rate"):
        faults.FaultRule("serve.dispatch", rate=1.5)
    with pytest.raises(ValueError, match="duplicate"):
        faults.FaultPlan(rules=[faults.FaultRule("serve.dispatch"),
                                faults.FaultRule("serve.dispatch")])
    with pytest.raises(ValueError, match="bad fault spec"):
        faults.FaultPlan.parse("just-a-site")
    assert faults.ACTIVE is None
    faults.fire("serve.dispatch")
    assert faults.should_fire("persist.spill") is False
    plan = faults.install(faults.FaultPlan(seed=0, rules=[
        faults.FaultRule("serve.dispatch", max_fires=2, after=1)]))
    fired = [faults.should_fire("serve.dispatch") for _ in range(6)]
    assert fired == [False, True, True, False, False, False]
    assert plan.fires["serve.dispatch"] == 2
    assert obs.get_default().counter(
        "faults_injected_total", labels={"site": "serve.dispatch"}).value == 2


def test_index_sites_fire_and_the_old_generation_serves(problem):
    eng = _engine(problem)
    qs = _queries(problem, 2)
    before = eng.query_batch(qs, K, C)
    faults.install(faults.FaultPlan(seed=0, rules=[
        faults.FaultRule("index.publish", max_fires=1),
        faults.FaultRule("index.rebuild", max_fires=1)]))
    with pytest.raises(faults.InjectedFault, match="index.publish"):
        eng.insert_items(problem[1][:1] * 2)
    assert eng.epoch == 0
    assert_bitwise(eng.query_batch(qs, K, C), before)
    with pytest.raises(faults.InjectedFault, match="index.rebuild"):
        eng.rebuild()
    assert eng.rebuild() is not None            # the next one runs
    assert eng.epoch == 1


def test_deadline_rejected_at_admission_and_swept(problem):
    eng = _engine(problem)
    qs = _queries(problem, MAX_BATCH + 1).numpy()
    with MicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=200.0) as mb:
        with pytest.raises(DeadlineExceeded):
            mb.submit(qs[0], K, C, deadline_ms=0.0)
        doomed = mb.submit(qs[0], K, C, deadline_ms=5.0)
        time.sleep(0.03)
        ok = [mb.submit(q, K, C) for q in qs[1:]]
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=WAIT)
        for f in ok:
            assert f.result(timeout=WAIT).indices.shape == (K,)
    st = mb.stats()
    assert st.expired == 2 and st.requests == MAX_BATCH
    assert sum(t.expired for t in mb.tick_log) == 2     # each attributed
    reg = obs.get_default()
    assert reg.counter("serve_rejected_total",
                       labels={"reason": "deadline"}).value == 2


def test_submit_after_close_raises_typed(problem):
    eng = _engine(problem)
    q = _queries(problem, 2).numpy()
    mb = MicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=0.5)
    try:
        f = mb.submit(q[0], K, C)
    finally:
        mb.close()
    mb.close()                                  # idempotent
    assert f.result(timeout=WAIT).indices.shape == (K,)
    with pytest.raises(SchedulerClosed):
        mb.submit(q[1], K, C)


@pytest.mark.parametrize("site,depth", [("serve.slow_tick", 1),
                                        ("serve.transfer", 2)])
def test_close_with_ticks_in_flight_leaves_no_torn_future(problem, site,
                                                          depth):
    eng = _engine(problem, "elastic:fused")
    qs = _queries(problem, 24, step=5).numpy()
    faults.install(faults.FaultPlan(seed=0, rules=[
        faults.FaultRule(site, mode="sleep", rate=1.0, latency_ms=40.0)]))
    mb = MicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=0.5,
                      pipeline_depth=depth)
    futs = []
    try:
        futs = [mb.submit(q, K, C) for q in qs]
    finally:
        closer = threading.Thread(target=lambda: mb.close(drain_s=0.07))
        closer.start()
        closer.join(timeout=WAIT)
    assert not closer.is_alive()
    direct = eng.query_batch(torch.from_numpy(qs), K, C)
    shed = 0
    for i, f in enumerate(futs):
        assert f.done(), "future left pending after close()"
        if f.exception(timeout=0) is not None:
            assert isinstance(f.exception(timeout=0), SchedulerClosed)
            shed += 1
        else:
            assert_bitwise(f.result(timeout=0), _row(direct, i))
    assert shed >= 1
    st = mb.stats()
    assert st.rejected == shed == sum(t.rejected for t in mb.tick_log)
    if depth == 2:
        assert max(t.inflight for t in mb.tick_log if t.batch > 0) >= 2


@pytest.mark.parametrize("site", ["serve.dispatch", "serve.transfer"])
def test_fault_fails_exactly_its_tick_and_recovers(problem, site):
    eng = _engine(problem, "elastic:fused")
    qs = _queries(problem, MAX_BATCH + 2).numpy()
    faults.install(faults.FaultPlan(seed=0, rules=[
        faults.FaultRule(site, mode="raise", max_fires=1)]))
    with MicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=50.0) as mb:
        doomed = [mb.submit(q, K, C, deadline_ms=1e-3) for q in qs[-2:]]
        time.sleep(0.01)
        bad = [mb.submit(q, K, C) for q in qs[:MAX_BATCH]]
        for f in doomed:
            with pytest.raises(DeadlineExceeded):
                f.result(timeout=WAIT)
        for f in bad:
            with pytest.raises(faults.InjectedFault):
                f.result(timeout=WAIT)
        good = [mb.submit(q, K, C) for q in qs[:MAX_BATCH]]
        direct = eng.query_batch(torch.from_numpy(qs[:MAX_BATCH]), K, C)
        for i, f in enumerate(good):
            assert_bitwise(f.result(timeout=WAIT), _row(direct, i))
    st = mb.stats()
    assert st.expired == 2 and sum(t.expired for t in mb.tick_log) == 2
    assert sum(t.rejected for t in mb.tick_log) == st.rejected
    assert sum(1 for t in mb.tick_log if t.batch > 0) == 1


# --------------------------------------------------------------- degrade
@pytest.mark.parametrize("policy", [
    dict(high_depth=8, low_depth=2, dwell_ticks=2, widen_c=1.5),
    dict(high_depth=8, low_depth=2, dwell_ticks=3),
    dict(high_depth=4, low_depth=1, dwell_ticks=1, max_level=2, widen_c=2.0)])
@pytest.mark.parametrize("with_cache", [False, True])
def test_degrade_rungs_match_the_reference(policy, with_cache):
    depths = [10, 10, 10, 10, 10, 10, 5, 1, 1, 1, 1, 20, 5, 20, 5, 20, 20,
              20, 20, 0, 0, 0, 0, 0, 0, 9, 3, 9, 9]
    port = DegradeController(
        DegradePolicy(**policy),
        cache=CachingBackend("dense") if with_cache else None)
    ref = ref_degrade.DegradeController(
        ref_degrade.DegradePolicy(**policy),
        cache=ref_cache.CachingBackend("dense") if with_cache else None)
    got = [port.on_tick_cut(d) for d in depths]
    assert got == [ref.on_tick_cut(d) for d in depths]
    assert port.transitions == ref.transitions
    assert port.effective_max == ref.effective_max
    assert port.widened_c(C) == ref.widened_c(C)
    with pytest.raises(ValueError):
        DegradePolicy(high_depth=2, low_depth=2)


def test_degrade_cache_only_serves_hits_sheds_misses(problem, monkeypatch):
    eng = _engine(problem, "cached:elastic:fused")
    qs = _queries(problem, 4)
    hots = [eng.query(q, K, C) for q in qs[:3]]     # warm the LRU
    dc = DegradeController(DegradePolicy(high_depth=50, low_depth=1,
                                         dwell_ticks=50),
                           backend=eng._backend)
    assert dc.cache is eng._backend and dc.effective_max == 3
    dc.level = 3
    copies = []
    real = sched_mod._host_result
    monkeypatch.setattr(sched_mod, "_host_result",
                        lambda r: copies.append(r) or real(r))
    with MicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=150.0,
                      degrade=dc) as mb:
        mb._admission_cache = None              # hits down to the tick
        futs = [mb.submit(q.numpy(), K, C) for q in qs]
        miss = futs.pop()
        got = [f.result(timeout=WAIT) for f in futs]
        with pytest.raises(QueueFull, match="degrade level 3"):
            miss.result(timeout=WAIT)
    for g, w in zip(got, hots):
        assert_bitwise(g, w)
    assert len(copies) == 1                     # one copy for the tick
    log = mb.tick_log
    assert any(t.degrade_level == 3 for t in log)
    assert sum(t.rejected for t in log) == mb.stats().rejected == 1


def test_degraded_tick_recorded_at_widened_contract(problem):
    eng = _engine(problem, "elastic:dense")
    qs = _queries(problem, MAX_BATCH)
    dc = DegradeController(DegradePolicy(high_depth=2, low_depth=1,
                                         dwell_ticks=1, max_level=2,
                                         widen_c=2.0), backend=eng._backend)
    with MicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=30.0,
                      degrade=dc) as mb:
        for _ in range(3):
            futs = [mb.submit(q.numpy(), K, C) for q in qs]
            for f in futs:
                r = f.result(timeout=WAIT)
                assert bool((r.r_lo <= r.r_up).all())
    levels = [t.degrade_level for t in mb.tick_log]
    assert max(levels) == 2
    assert eng._backend._degrade_level == dc.level
    at_2 = eng.query_batch(qs, K, 2.0 * C)
    last = [f.result(timeout=WAIT) for f in futs]
    if mb.tick_log[-1].degrade_level == 2:
        for i, r in enumerate(last):
            assert_bitwise(r, _row(at_2, i))
