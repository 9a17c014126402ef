"""Low-overhead serving metrics: counters, gauges, fixed-bucket histograms.

The serving stack (scheduler ticks, cache lookups, pruned-scan phases,
elastic repads, maintenance rebuilds, the quality auditor) publishes into
ONE process-global `MetricsRegistry`, exported two ways:

  * `to_prometheus_text()` — the Prometheus text exposition format, served
    by `start_http_server(port)` at ``/metrics`` (and ``/metrics.json``);
  * `snapshot()` — a plain JSON-able dict, embedded in `perf_engine
    --json` artifacts so bench runs carry the same counters a live fleet
    exposes.

Design constraints (this is ON the serving path, so it must be boring):

  * stdlib only — importing this module must not pull in numpy or torch;
  * one `threading.Lock` per instrument, held for a few float ops;
    `observe()` on a histogram is a bisect over ~100 bucket bounds;
  * instruments are get-or-create by (name, labels) and live for the
    process — call sites cache them at module scope, and `reset()` zeroes
    VALUES in place so cached references stay valid across tests;
  * nothing here runs per user row. Per-row work is instrumented at the
    tick/batch level by the callers.

Histogram percentile reconstruction
-----------------------------------
Buckets are FIXED at construction (default: log-spaced latency bounds,
~4 buckets per octave from 1 µs to 60 s, in ms). Each bucket additionally
tracks the min/max observation it absorbed, so `percentile(p)` is:

  * EXACT whenever the bucket straddling the requested rank is degenerate
    (all its observations equal — true in particular for any observation
    stream drawn from the bucket boundaries themselves, the regression
    surface tests/test_obs.py pins);
  * otherwise linearly interpolated between that bucket's observed
    min/max, so the error is bounded by ONE bucket's width (≈ 19%
    relative at the default spacing) rather than by the histogram range.

`p50()`/`p99()` are the dashboard shorthands.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_latency_bounds", "get_default", "set_default",
    "counter", "gauge", "histogram", "start_http_server",
]

LabelsT = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[dict]) -> LabelsT:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(labels: LabelsT, extra: Optional[List[Tuple[str, str]]]
                   = None) -> str:
    pairs = list(labels) + (extra or [])
    if not pairs:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + body + "}"


class _Instrument:
    """Shared identity/locking plumbing for the three instrument kinds."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: LabelsT = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = threading.Lock()


class Counter(_Instrument):
    """Monotone float counter (`inc` only; `reset()` re-zeroes)."""

    kind = "counter"

    def __init__(self, name, help="", labels=()):
        super().__init__(name, help, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge(_Instrument):
    """Last-write-wins float gauge; `set_fn` makes it a CALLBACK gauge
    whose value is read lazily at export time (e.g. the elastic backend's
    compiled-program count — sampling it per export beats paying the scan
    per tick)."""

    kind = "gauge"

    def __init__(self, name, help="", labels=(),
                 set_fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help, labels)
        self._value = 0.0
        self._fn = set_fn

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._fn = None         # explicit set wins over the callback

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:                        # callback outside the lock
            return float(fn())
        except Exception:
            return float("nan")

    def _reset(self) -> None:
        with self._lock:
            if self._fn is None:
                self._value = 0.0


def default_latency_bounds(lo_ms: float = 1e-3, hi_ms: float = 60_000.0,
                           per_octave: int = 4) -> Tuple[float, ...]:
    """Log-spaced bucket UPPER bounds in milliseconds: `per_octave`
    buckets per factor of two from `lo_ms` to at least `hi_ms` (~101
    buckets at the defaults — fine-grained enough that one-bucket
    interpolation error is ≈ 2^(1/per_octave) − 1 ≈ 19% relative)."""
    n = int(math.ceil(math.log2(hi_ms / lo_ms) * per_octave)) + 1
    return tuple(lo_ms * 2.0 ** (i / per_octave) for i in range(n))


class Histogram(_Instrument):
    """Fixed-bucket histogram with per-bucket min/max for percentile
    reconstruction (module docstring). Observations above the last bound
    land in the implicit +Inf bucket."""

    kind = "histogram"

    def __init__(self, name, help="", labels=(),
                 bounds: Optional[Iterable[float]] = None):
        super().__init__(name, help, labels)
        b = tuple(float(x) for x in (bounds if bounds is not None
                                     else default_latency_bounds()))
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram {name}: bounds must be a "
                             f"non-empty strictly increasing sequence")
        self.bounds = b
        nb = len(b) + 1                     # + the +Inf bucket
        self._counts = [0] * nb
        self._mins = [math.inf] * nb
        self._maxs = [-math.inf] * nb
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        # bucket i holds observations with  bounds[i-1] < v <= bounds[i]
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            if v < self._mins[i]:
                self._mins[i] = v
            if v > self._maxs[i]:
                self._maxs[i] = v
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile reconstructed from the buckets
        (exactness contract in the module docstring); 0.0 when empty."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100]; got {p}")
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            rank = max(0, math.ceil(p / 100.0 * total) - 1)   # 0-based
            cum = 0
            for i, cnt in enumerate(self._counts):
                if cnt == 0:
                    continue
                if rank < cum + cnt:
                    lo, hi = self._mins[i], self._maxs[i]
                    if lo == hi:
                        return lo           # degenerate bucket: exact
                    frac = (rank - cum) / (cnt - 1)
                    return lo + (hi - lo) * frac
                cum += cnt
        return 0.0                          # unreachable

    def p50(self) -> float:
        return self.percentile(50.0)

    def p99(self) -> float:
        return self.percentile(99.0)

    def _reset(self) -> None:
        with self._lock:
            nb = len(self.bounds) + 1
            self._counts = [0] * nb
            self._mins = [math.inf] * nb
            self._maxs = [-math.inf] * nb
            self._sum = 0.0
            self._count = 0

    def _cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative count), ...] incl. +Inf, for the exporter."""
        out, cum = [], 0
        with self._lock:
            for le, cnt in zip(self.bounds + (math.inf,), self._counts):
                cum += cnt
                out.append((le, cum))
        return out


class MetricsRegistry:
    """Get-or-create instrument registry keyed on (name, labels).

    A name maps to ONE instrument kind — re-requesting with a different
    kind (or different histogram bounds) raises, so two call sites cannot
    silently split a time series.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[Tuple[str, LabelsT], _Instrument]" = {}

    def _get_or_create(self, cls, name, help, labels, **kw):
        key = (name, _labels_key(labels))
        with self._lock:
            hit = self._metrics.get(key)
            if hit is not None:
                if not isinstance(hit, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{hit.kind}, requested {cls.kind}")
                if (isinstance(hit, Histogram) and kw.get("bounds")
                        is not None
                        and tuple(kw["bounds"]) != hit.bounds):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"different bounds")
                return hit
            inst = cls(name, help, key[1], **kw)
            self._metrics[key] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None,
              set_fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get_or_create(Gauge, name, help, labels, set_fn=set_fn)
        if set_fn is not None and g._fn is None and g._value == 0.0:
            g.set_function(set_fn)
        return g

    def histogram(self, name: str, help: str = "",
                  labels: Optional[dict] = None,
                  bounds: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   bounds=bounds)

    def metrics(self) -> List[_Instrument]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        """Zero every instrument IN PLACE (cached call-site references
        stay valid — tests use this between cases)."""
        for m in self.metrics():
            m._reset()

    # ----------------------------------------------------------- exporters
    def snapshot(self) -> dict:
        """JSON-able dump: {name: [{labels, ...kind-specific}]}."""
        out: dict = {}
        for m in self.metrics():
            entry: dict = {"labels": dict(m.labels), "type": m.kind}
            if isinstance(m, Histogram):
                entry.update(
                    count=m.count, sum=m.sum,
                    p50=m.p50(), p99=m.p99(),
                    buckets=[{"le": le, "cumulative": c}
                             for le, c in m._cumulative()
                             if c or math.isinf(le)])
            else:
                entry["value"] = m.value
            out.setdefault(m.name, []).append(entry)
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format (one scrape body)."""
        lines: List[str] = []
        seen_header = set()
        by_name: "Dict[str, List[_Instrument]]" = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        for name in sorted(by_name):
            for m in by_name[name]:
                if name not in seen_header:
                    if m.help:
                        lines.append(f"# HELP {name} {m.help}")
                    lines.append(f"# TYPE {name} {m.kind}")
                    seen_header.add(name)
                if isinstance(m, Histogram):
                    for le, cum in m._cumulative():
                        le_s = "+Inf" if le is math.inf or le == math.inf \
                            else repr(le)
                        lines.append(
                            f"{name}_bucket"
                            f"{_render_labels(m.labels, [('le', le_s)])} "
                            f"{cum}")
                    lines.append(f"{name}_sum{_render_labels(m.labels)} "
                                 f"{m.sum!r}")
                    lines.append(f"{name}_count{_render_labels(m.labels)} "
                                 f"{m.count}")
                else:
                    v = m.value
                    lines.append(f"{name}{_render_labels(m.labels)} {v!r}")
        return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def get_default() -> MetricsRegistry:
    """The process-global registry every serving component publishes to."""
    return _DEFAULT


def set_default(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests). Call-site-cached
    instruments keep pointing at the OLD registry — prefer
    `get_default().reset()` unless isolation is the point."""
    global _DEFAULT
    _DEFAULT = reg
    return reg


def counter(name: str, help: str = "",
            labels: Optional[dict] = None) -> Counter:
    return _DEFAULT.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Optional[dict] = None,
          set_fn: Optional[Callable[[], float]] = None) -> Gauge:
    return _DEFAULT.gauge(name, help, labels, set_fn=set_fn)


def histogram(name: str, help: str = "", labels: Optional[dict] = None,
              bounds: Optional[Iterable[float]] = None) -> Histogram:
    return _DEFAULT.histogram(name, help, labels, bounds=bounds)


# ------------------------------------------------------------ HTTP export
def start_http_server(port: int, registry: Optional[MetricsRegistry] = None,
                      host: str = "127.0.0.1"):
    """Serve the registry at ``http://host:port/metrics`` (Prometheus
    text) and ``/metrics.json`` (the `snapshot()` dict) from a daemon
    thread. Port 0 binds an ephemeral port; read it back from the
    returned server's ``server_address``. `shutdown()` the returned
    `ThreadingHTTPServer` to stop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry if registry is not None else get_default()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):                                   # noqa: N802
            if self.path.split("?")[0] == "/metrics.json":
                body = json.dumps(
                    {"unix_time": time.time(), "metrics": reg.snapshot()},
                    default=str).encode()
                ctype = "application/json"
            elif self.path.split("?")[0] in ("/metrics", "/"):
                body = reg.to_prometheus_text().encode()
                ctype = "text/plain; version=0.0.4"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):          # quiet: scrapes are periodic
            pass

    srv = ThreadingHTTPServer((host, int(port)), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="metrics-http")
    t.start()
    return srv
