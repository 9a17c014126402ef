"""Serving observability: the metrics registry and trace spans.

Counterpart of `repro/obs`:

  * `repro_torch.obs.registry` — counters / gauges / fixed-bucket latency
    histograms in a process-global `MetricsRegistry`, with Prometheus
    text and JSON snapshot exporters and an optional scrape HTTP server
    (a copy of the reference's stdlib-only module);
  * `repro_torch.obs.trace` — nestable monotonic-clock spans in a ring
    buffer, disabled by default, with opt-in `torch.profiler` annotations.

Both are stdlib-only at import and safe to import from any module of
the port. The reference's quality auditor (`obs/audit.py`) is not ported
yet.
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
    "counter",
    "default_latency_bounds",
    "gauge",
    "get_default",
    "histogram",
    "set_default",
    "start_http_server",
    "trace",
]
