"""The port's observability (`repro_torch.obs`) against the reference's
(`repro.obs`): the registry is a copy of the reference's stdlib module,
so the same operations must give the same Prometheus text and snapshot;
the trace spans keep the reference's nesting, ring buffer and switches,
with `torch.profiler.record_function` as the profiler hook; the engine's
counters and the `engine.delta_correct` span. Templates:
tests/test_obs.py (the HTTP exporter, the elastic jit-cache scan and the
quality auditor are left out: the first is the same stdlib code, the
second has no counterpart in the port, and the auditor is not ported).
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
