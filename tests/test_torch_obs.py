"""The port's observability (`repro_torch.obs`) against the reference's
(`repro.obs`): the registry is a copy of the reference's stdlib module,
so the same operations must give the same Prometheus text and snapshot;
the trace spans keep the reference's nesting, ring buffer and switches,
with `torch.profiler.record_function` as the profiler hook; the engine's
counters and the `engine.delta_correct` span; the quality auditor
(`repro_torch.obs.audit`): its sampled subset equals the reference
auditor's for a seed and an observation order, its arguments and
endpoints behave as the reference's, both packages' auditors give the
same gauges on the same engines and served results, one oracle launch a
sample, and an `audit.loop` fault flips `audit_thread_alive`. Templates:
tests/test_obs.py and tests/test_faults.py:237 (the HTTP exporter and
the elastic jit-cache scan are left out: the first is the same stdlib
code, the second has no counterpart in the port).
"""
import math
import threading

import numpy as np
import pytest
import torch

from repro.obs import registry as ref_obs
from repro.obs import trace as ref_trace
from repro_torch.core import elastic
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.types import RankTableConfig
from repro_torch.obs import registry as obs
from repro_torch.obs import trace


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def clean_trace():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _drive(module):
    """One sequence of registry operations on a private registry."""
    reg = module.MetricsRegistry()
    reg.counter("req_total", "requests").inc(3)
    reg.counter("rej_total", "rejects", labels={"reason": "deadline"}).inc()
    reg.gauge("depth", labels={"mode": "serve"}).set(2.0)
    reg.gauge("live", "callback").set_function(lambda: 7.0)
    h = reg.histogram("lat_ms", bounds=(1.0, 2.0, 4.0))
    for v in (1.5, 3.0, 0.5, 9.0, 2.0):
        h.observe(v)
    d = reg.histogram("default_ms")
    for v in np.linspace(0.01, 50.0, 37):
        d.observe(float(v))
    return reg


def test_registry_text_and_snapshot_match_the_reference():
    got, want = _drive(obs), _drive(ref_obs)
    assert got.to_prometheus_text() == want.to_prometheus_text()
    assert got.snapshot() == want.snapshot()
    for p in (0.0, 50.0, 99.0, 100.0):
        assert got.histogram("default_ms").percentile(p) == \
            want.histogram("default_ms").percentile(p)


def test_registry_api_is_the_reference_api():
    public = lambda m: {n for n in dir(m) if not n.startswith("_")}
    assert public(obs) >= public(ref_obs) - {"annotations"}
    assert obs.default_latency_bounds() == ref_obs.default_latency_bounds()


def test_reset_keeps_references_and_zeroes_values():
    reg = obs.MetricsRegistry()
    c = reg.counter("x_total")
    c.inc(5)
    reg.reset()
    assert reg.counter("x_total") is c and c.value == 0.0
    with pytest.raises(TypeError):
        reg.gauge("x_total")                # kind conflict


def test_disabled_trace_is_shared_null_span(clean_trace):
    assert not trace.is_enabled()
    sp = trace.span("x", a=1)
    assert sp is trace.span("y")
    with sp as s:
        s.set(b=2)
    trace.event("e", 0.0, 1.0)
    assert trace.spans() == []


def test_span_nesting_attrs_and_events(clean_trace):
    trace.enable()
    with trace.span("outer", a=1) as sp:
        sp.set(b=2)
        with trace.span("inner"):
            trace.event("queue_wait", 123.0, 0.25, k=5)
    inner, = trace.spans("inner")
    outer, = trace.spans("outer")
    ev, = trace.spans("queue_wait")
    assert inner.depth == 1 and inner.parent == "outer"
    assert outer.depth == 0 and outer.parent is None
    assert outer.attrs == (("a", 1), ("b", 2))
    assert ev.t_start == 123.0 and ev.parent == "inner" and ev.depth == 2


def test_span_stacks_are_per_thread(clean_trace):
    trace.enable()
    barrier = threading.Barrier(4)

    def work(tid):
        for _ in range(10):
            with trace.span("outer", tid=tid):
                barrier.wait(timeout=30)
                with trace.span("inner", tid=tid):
                    pass

    threads = [threading.Thread(target=work, args=(i,), name=f"w{i}")
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    recs = trace.spans()
    assert len([r for r in recs if r.name == "inner"]) == 40
    for r in recs:
        assert (r.depth, r.parent) == ((1, "outer") if r.name == "inner"
                                       else (0, None))
        assert r.thread == f"w{dict(r.attrs)['tid']}"


def test_ring_buffer_capacity_and_clear(clean_trace):
    trace.enable()
    trace.set_capacity(8)
    try:
        for i in range(20):
            with trace.span("s", i=i):
                pass
        recs = trace.spans("s")
        assert len(recs) == 8 and dict(recs[-1].attrs)["i"] == 19
        trace.clear()
        assert trace.spans() == []
        with pytest.raises(ValueError):
            trace.set_capacity(0)
    finally:
        trace.set_capacity(4096)


def test_profiler_spans_reach_torch_profiler(clean_trace):
    """profiler=True opens a `torch.profiler.record_function` per span,
    which a torch.profiler trace shows by name (the reference opens a
    jax.profiler annotation at the same place)."""
    trace.enable(profiler=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("serve.tick"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "serve.tick" in names
    assert trace.spans("serve.tick")


def test_env_switches_match_the_reference():
    """REPRO_OBS_SPANS / REPRO_OBS_PROFILER are read at import, with the
    same accepted values."""
    import inspect
    src, ref_src = inspect.getsource(trace), inspect.getsource(ref_trace)
    tail = lambda s: s[s.index('if os.environ.get("REPRO_OBS_SPANS"'):]
    assert tail(src) == tail(ref_src)


def test_engine_counts_queries_and_spans_the_delta_path(clean_trace):
    rng = np.random.default_rng(0)
    users = torch.from_numpy(rng.integers(-4, 5, (200, 8)).astype(np.float32))
    items = torch.from_numpy(rng.integers(-4, 5, (60, 8)).astype(np.float32))
    eng = ReverseKRanksEngine.build(users, items, RankTableConfig(
        tau=8, omega=2, s=4), 0, backend="dense", device="cpu")
    reg = obs.get_default()
    total = reg.counter("engine_queries_total")
    delta = reg.counter("engine_delta_queries_total")
    t0, d0 = total.value, delta.value
    trace.enable()
    eng.query_batch(items[:3], 5, 2.0)
    assert total.value == t0 + 3 and delta.value == d0
    assert trace.spans("engine.delta_correct") == []
    eng.insert_items(items[:2] * 2)
    eng.query_batch(items[:4], 5, 2.0)
    eng.dispatch_batch_at(eng.current_snapshot(), items[:2].numpy(), 5, 2.0)
    assert total.value == t0 + 9 and delta.value == d0 + 6
    spans = trace.spans("engine.delta_correct")
    assert [dict(s.attrs)["batch"] for s in spans] == [4, 2]
    assert all(dict(s.attrs)["epoch"] == 1 for s in spans)


def test_compiled_program_gauge_reads_the_elastic_counter():
    # elastic registers its gauge with the default registry when it is
    # first imported: at collection here, before any test swaps it
    g = obs.get_default().gauge("query_compiled_programs")
    assert g.value == float(elastic.compiled_program_count())
    assert not math.isnan(g.value)


def test_set_default_returns_the_registry_it_installs():
    """`set_default` returns the NEW registry (the reference's API), so a
    test that swaps the default keeps `get_default()` first. The pruned
    telemetry case of tests/test_torch_pruning.py once restored the
    return value, which left its private registry installed: on an xdist
    worker that ran it before this file, the elastic gauge above was
    missing from the default and read 0."""
    old = obs.get_default()
    new = obs.MetricsRegistry()
    try:
        assert obs.set_default(new) is new
        assert obs.get_default() is new
    finally:
        obs.set_default(old)
    assert obs.get_default() is old
    assert old.gauge("query_compiled_programs").value == float(
        elastic.compiled_program_count())


# ---------------------------------------------------------------- auditor
class _NoSnapshotEngine:
    """Engine stub with no `current_snapshot`: every sampled query is
    skipped by the scorer, which is all the sampling tests need."""


def _observe_sequence(auditor_cls, registry_mod, seed, n, fraction):
    reg = registry_mod.MetricsRegistry()
    aud = auditor_cls(_NoSnapshotEngine(), fraction=fraction, seed=seed,
                      registry=reg)
    try:
        picks = [aud.observe(np.zeros(4, np.float32), None, k=5, c=2.0)
                 for _ in range(n)]
        assert aud.flush(timeout=30)
    finally:
        aud.close()
    counts = [reg.counter(name).value for name in (
        "audit_observed_total", "audit_sampled_total", "audit_skipped_total")]
    return picks, counts


def test_auditor_samples_the_reference_subset():
    """The same seed and observation order sample the same subset in both
    packages; another seed moves it; snapshot-less samples are skipped,
    never scored."""
    from repro.obs.audit import QualityAuditor as RefAuditor
    from repro_torch.obs import QualityAuditor
    for seed, fraction in ((0, 0.5), (1, 0.5), (5, 0.05), (9, 0.3)):
        got, (seen, sampled, skipped) = _observe_sequence(
            QualityAuditor, obs, seed, 200, fraction)
        want, want_counts = _observe_sequence(RefAuditor, ref_obs, seed,
                                              200, fraction)
        assert got == want, (seed, fraction)
        assert [seen, sampled, skipped] == want_counts
        assert seen == 200 and sampled == sum(got) == skipped
    a, _ = _observe_sequence(QualityAuditor, obs, 0, 200, 0.5)
    b, _ = _observe_sequence(QualityAuditor, obs, 1, 200, 0.5)
    assert a != b and 0 < sum(a) < 200


def test_auditor_fraction_endpoints_and_arguments():
    from repro_torch.obs import QualityAuditor
    none, (_, samp0, _) = _observe_sequence(QualityAuditor, obs, 3, 50, 0.0)
    assert not any(none) and samp0 == 0
    every, (_, samp1, _) = _observe_sequence(QualityAuditor, obs, 3, 50,
                                             1.0)
    assert all(every) and samp1 == 50
    for kw in (dict(fraction=1.5), dict(fraction=-0.1), dict(window=0)):
        with pytest.raises(ValueError):
            QualityAuditor(_NoSnapshotEngine(),
                           registry=obs.MetricsRegistry(), **kw)
    aud = QualityAuditor(_NoSnapshotEngine(), fraction=0.0,
                         registry=obs.MetricsRegistry())
    try:
        assert math.isnan(aud.overall_ratio)
        assert math.isnan(aud.accuracy)
        assert math.isnan(aud.bound_width)
        assert aud.scored == 0
    finally:
        aud.close()


def test_auditor_queue_is_bounded():
    """Past max_pending a sample is dropped and counted, never queued."""
    from repro_torch.obs import QualityAuditor
    reg = obs.MetricsRegistry()
    gate = threading.Event()

    class _Blocking:
        """A snapshot whose users the scorer waits for: it holds at most
        one sample, the queue the rest."""

        users = torch.zeros((1, 4))

        def live_items(self):
            gate.wait(timeout=30)
            raise ValueError("no item set")

    aud = QualityAuditor(_NoSnapshotEngine(), fraction=1.0, max_pending=2,
                         registry=reg)
    try:
        picks = [aud.observe(np.zeros(4, np.float32), None, k=5, c=2.0,
                             snapshot=_Blocking()) for _ in range(5)]
        dropped = reg.counter("audit_dropped_total").value
        backlog = reg.gauge("audit_backlog").value
    finally:
        gate.set()
        assert aud.flush(timeout=30)
        aud.close()
    assert picks[:2] == [True, True] and not any(picks[3:])
    assert sum(picks) + dropped == 5 and dropped >= 2
    assert backlog <= 2
    assert reg.counter("audit_skipped_total").value == sum(picks)


@pytest.fixture(scope="module")
def audit_engines():
    """A reference engine and the port engine on its table, positions and
    weights (integer users and items: every score exact in any order), and
    the reference's served results of eight item queries."""
    import jax
    import jax.numpy as jnp
    from repro.core import rank_table as R
    from repro.core.engine import ReverseKRanksEngine as RefEngine
    from repro.core.types import RankTableConfig as RefConfig
    from repro_torch import convert
    rng = np.random.default_rng(4)
    users = rng.integers(-4, 5, (300, 12)).astype(np.float32)
    items = rng.integers(-4, 5, (150, 12)).astype(np.float32)
    rcfg = RefConfig(tau=16, omega=4, s=8)
    key = jax.random.PRNGKey(1)
    ref = RefEngine.build(jnp.asarray(users), jnp.asarray(items), rcfg, key)
    pos, w = R.stratified_sample_indices(key, 150, rcfg)
    st = convert.from_reference(ref.rank_table, users, items, pos, w,
                                device="cpu")
    port = ReverseKRanksEngine(st.users, st.rank_table,
                               RankTableConfig(tau=16, omega=4, s=8),
                               items=st.items, positions=st.positions,
                               weights=st.weights)
    qs = items[(3 + np.arange(8) * 11) % 150]
    res = ref.query_batch(jnp.asarray(qs), 7, 2.0)
    served = [type("R", (), {f: np.asarray(getattr(res, f))[b]
                             for f in ("indices", "r_lo", "r_up")})()
              for b in range(qs.shape[0])]
    return ref, port, qs, served


def test_auditors_of_both_packages_agree(audit_engines):
    """At fraction 1.0, both packages' auditors, each on its own engine,
    score the same served results of the same queries into the same
    rolling gauges (the exact ranks are integer counts)."""
    from repro.obs.audit import QualityAuditor as RefAuditor
    from repro_torch.obs import QualityAuditor
    ref, port, qs, served = audit_engines
    out = {}
    for name, cls, eng, reg in (
            ("port", QualityAuditor, port, obs.MetricsRegistry()),
            ("reference", RefAuditor, ref, ref_obs.MetricsRegistry())):
        aud = cls(eng, fraction=1.0, seed=0, registry=reg)
        try:
            for q, r in zip(qs, served):
                assert aud.observe(q, r, k=7, c=2.0)
            assert aud.flush(timeout=120)
        finally:
            aud.close()
        out[name] = [reg.gauge(g).value for g in (
            "audit_overall_ratio", "audit_accuracy", "audit_bound_width")] \
            + [reg.counter(c).value for c in (
                "audit_scored_total", "audit_skipped_total")]
    assert out["port"] == out["reference"]
    assert out["port"][3] == len(qs) and out["port"][4] == 0
    assert out["port"][0] >= 1.0 and 0.0 <= out["port"][1] <= 1.0


def test_auditor_scores_with_one_oracle_launch(audit_engines):
    """A sample costs one exact-rank call: the exact answer is the k
    smallest of the same ranks (what `reverse_k_ranks` computes with a
    second call), so the gauges equal a grade by `reverse_k_ranks`."""
    from repro_torch.core import exact, metrics
    from repro_torch.kernels import ops
    from repro_torch.obs import QualityAuditor
    _, port, qs, served = audit_engines
    reg = obs.MetricsRegistry()
    calls = []
    orig = ops.exact_ranks

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    ops.exact_ranks = counting
    aud = QualityAuditor(port, fraction=1.0, registry=reg)
    try:
        for q, r in zip(qs, served):
            aud.observe(q, r, k=7, c=2.0)
        assert aud.flush(timeout=120)
    finally:
        aud.close()
        ops.exact_ranks = orig
    assert len(calls) == len(qs)
    users, items = port.users, port.live_items()
    ratios, accs = [], []
    for q, r in zip(qs, served):
        idx, _ = exact.reverse_k_ranks(users, items, torch.from_numpy(q), 7)
        truth = exact.exact_ranks(users, items, torch.from_numpy(q)).numpy()
        ratios.append(metrics.overall_ratio(r.indices, idx.numpy(), truth))
        accs.append(metrics.accuracy(r.indices, idx.numpy(), truth, 2.0))
    assert aud.overall_ratio == pytest.approx(np.mean(ratios), rel=1e-12)
    assert aud.accuracy == pytest.approx(np.mean(accs), rel=1e-12)


def test_auditor_behind_the_micro_batcher(audit_engines):
    """`MicroBatcher(auditor=)` offers every resolved request with its
    pinned snapshot; at fraction 1.0 each one is scored."""
    from repro_torch.obs import QualityAuditor
    from repro_torch.serve import MicroBatcher
    _, port, qs, _ = audit_engines
    reg = obs.MetricsRegistry()
    aud = QualityAuditor(port, fraction=1.0, registry=reg)
    mb = MicroBatcher(port, max_batch=4, max_wait_ms=1.0, auditor=aud)
    try:
        futs = [mb.submit(q, 7, 2.0) for q in qs]
        for f in futs:
            f.result(timeout=60)
        mb.flush()
        assert aud.flush(timeout=120)
    finally:
        mb.close()
        aud.close()
    assert reg.counter("audit_scored_total").value == len(qs)
    assert reg.counter("audit_skipped_total").value == 0
    assert aud.overall_ratio >= 1.0


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_audit_thread_death_flips_liveness_gauge():
    from repro_torch.obs import QualityAuditor
    from repro_torch.serve import faults
    faults.install(faults.FaultPlan(seed=0, rules=[
        faults.FaultRule("audit.loop", mode="raise", max_fires=1)]))
    aud = QualityAuditor(engine=object(), fraction=1.0, seed=0,
                         registry=obs.MetricsRegistry())
    try:
        assert aud._m_alive.value == 1.0
        assert aud.observe(np.zeros(4, np.float32), None, k=5, c=2.0)
        aud._thread.join(timeout=10)
        assert not aud._thread.is_alive()
        assert aud._m_alive.value == 0.0
        # the fault restored _in_flight: flush() ends on a dead scorer
        assert aud.flush(timeout=1.0)
    finally:
        faults.clear()
        aud.close()
