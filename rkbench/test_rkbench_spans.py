"""The readers of the program's query-path spans: the four device-time
readers on a made-up trace reduced by `trace.summarize`, the two
host-time readers on made-up `SpanRecord`s of the program's ring buffer,
and each silent (None) where its spans are absent."""
import pytest

from rkbench import manifest, trace

DEVICE_READERS = {"step1.device_ms_per_batch": "query.step1",
                  "select.device_ms_per_batch": "query.select",
                  "select.kth_ms_per_batch": "select.kth",
                  "select.lemma1_ms_per_batch": "select.lemma1"}
HOST_READERS = {"query.host_ms_per_batch": "query.batch",
                "step1.host_ms_per_batch": "query.step1"}


def _batch(t0: int, corr: int):
    """One batch's host and device events from `t0` (ns): the program's
    spans inside the benchmark's, a step-1 kernel whose launch left no
    record (placed by `query.step1`'s device range), the selection's
    kernels launched by runtime calls."""
    host = [
        (t0, t0 + 100, "rkbench.batch", 1, corr, 0, True),
        (t0, t0 + 90, "rkbench.query_batch", 1, corr + 1, 0, True),
        (t0 + 1, t0 + 89, "query.batch", 1, corr + 2, 0, True),
        (t0 + 2, t0 + 20, "query.step1", 1, corr + 3, 0, True),
        (t0 + 21, t0 + 88, "query.select", 1, corr + 4, 0, True),
        (t0 + 22, t0 + 40, "select.kth", 1, corr + 5, 0, True),
        (t0 + 23, t0 + 24, "cudaLaunchKernel", 1, corr + 10, 1, False),
        (t0 + 41, t0 + 70, "select.lemma1", 1, corr + 6, 0, True),
        (t0 + 42, t0 + 43, "cudaLaunchKernel", 1, corr + 11, 1, False),
        (t0 + 75, t0 + 76, "cudaLaunchKernel", 1, corr + 12, 1, False),
    ]
    device = [
        (t0 + 10, t0 + 40, "step1_ring_kernel<16>", 0, 0, False),
        (t0 + 40, t0 + 50, "topk_kernel", corr + 10, 0, False),
        (t0 + 50, t0 + 70, "sort_kernel", corr + 11, 0, False),
        (t0 + 70, t0 + 74, "gather_kernel", corr + 12, 0, False),
        (t0 + 10, t0 + 40, "query.step1", 0, 0, True),
    ]
    return host, device


def _summary(batches: int = 2) -> dict:
    host, device = [], []
    for b in range(batches):
        h, d = _batch(1000 * b, 100 * b + 1)
        host += h
        device += d
    return trace.summarize(host, device)


def _ctx(summary):
    return {"trace": summary}


def test_device_readers_on_a_made_up_trace():
    t = _summary()
    got = {name: manifest.metric_reader(name)(_ctx(t))
           for name in DEVICE_READERS}
    ms = 1e-6                       # 1 ns a batch in ms
    assert got["step1.device_ms_per_batch"] == pytest.approx(30 * ms)
    assert got["select.kth_ms_per_batch"] == pytest.approx(10 * ms)
    assert got["select.lemma1_ms_per_batch"] == pytest.approx(20 * ms)
    assert got["select.device_ms_per_batch"] == pytest.approx(34 * ms)
    assert got["select.kth_ms_per_batch"] \
        + got["select.lemma1_ms_per_batch"] \
        <= got["select.device_ms_per_batch"]
    # step 1's span holds the ring kernel's time a batch, by name
    ring = sum(s for n, s in t["device_s_by_name"].items()
               if "step1_ring_kernel" in n) / t["batches"]
    assert got["step1.device_ms_per_batch"] == pytest.approx(1e3 * ring)


@pytest.mark.parametrize("name,span", sorted(DEVICE_READERS.items()))
def test_device_readers_are_silent_without_their_spans(name, span):
    read = manifest.metric_reader(name)
    assert read(_ctx(None)) is None and read(_ctx({})) is None
    host, device = _batch(0, 1)
    t = trace.summarize([h for h in host if h[2] != span], device)
    assert t and read(_ctx(t)) is None


def _record(name, duration_s, i):
    from repro_torch.obs.trace import SpanRecord
    return SpanRecord(name=name, t_start=float(i), duration_s=duration_s,
                      depth=0, parent=None, thread="MainThread",
                      trace_id=i + 1, span_id=i + 1)


@pytest.mark.parametrize("name,span", sorted(HOST_READERS.items()))
def test_host_readers_take_the_median_of_the_records(monkeypatch, name,
                                                     span):
    from repro_torch.obs import trace as spans
    recs = [_record(span, s, i) for i, s in
            enumerate([0.003, 0.001, 0.002, 0.010, 0.0015])]
    recs.append(_record("other.span", 1.0, 9))
    monkeypatch.setattr(spans, "spans", lambda n=None: [
        r for r in recs if n is None or r.name == n])
    read = manifest.metric_reader(name)
    assert read(_ctx(_summary())) == pytest.approx(2.0)
    assert read(_ctx(None)) is None         # not a traced run


@pytest.mark.parametrize("name,span", sorted(HOST_READERS.items()))
def test_host_readers_are_silent_without_their_spans(monkeypatch, name,
                                                     span):
    from repro_torch.obs import trace as spans
    others = [_record("prune.query", 0.001, 0)]
    monkeypatch.setattr(spans, "spans", lambda n=None: [
        r for r in others if n is None or r.name == n])
    assert manifest.metric_reader(name)(_ctx(_summary())) is None
