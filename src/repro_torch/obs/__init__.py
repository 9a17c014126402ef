"""Serving observability: the metrics registry, trace spans and the
quality auditor.

Counterpart of `repro/obs`:

  * `repro_torch.obs.registry` — counters / gauges / fixed-bucket latency
    histograms in a process-global `MetricsRegistry`, with Prometheus
    text and JSON snapshot exporters and an optional scrape HTTP server
    (a copy of the reference's stdlib-only module);
  * `repro_torch.obs.trace` — nestable monotonic-clock spans in a ring
    buffer, disabled by default, with opt-in `torch.profiler` annotations;
    each record carries a trace id shared by a root span and everything
    under it (one query batch: `query.batch` around `query.step1` and
    `query.select`, which holds `select.kth` and `select.lemma1`), its own
    and its parent's span ids, and `start_ns`, its start on the profiler's
    clock;
  * `repro_torch.obs.audit` — the online quality auditor: shadow-samples
    served queries and re-scores them exactly in the background (K3 on a
    CUDA stream of its own), publishing rolling §5 overall-ratio and
    accuracy gauges.

`registry` and `trace` are stdlib-only at import and safe to import from
any module of the port; `audit` needs numpy and the oracle and is loaded
on first attribute access, as in the reference.
"""
from __future__ import annotations

from repro_torch.obs import trace
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    default_latency_bounds,
    gauge,
    get_default,
    histogram,
    set_default,
    start_http_server,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "QualityAuditor",
    "counter",
    "default_latency_bounds",
    "gauge",
    "get_default",
    "histogram",
    "set_default",
    "start_http_server",
    "trace",
]


def __getattr__(name):
    if name == "QualityAuditor":        # defer numpy and the oracle
        from repro_torch.obs.audit import QualityAuditor
        return QualityAuditor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
