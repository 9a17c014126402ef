"""Structured per-query trace spans for the serving path (a port of
`repro/obs/trace.py`; the profiler hook is `torch.profiler`).

A span is one timed region on ONE thread — admission→dispatch queue wait,
a cache lookup, the pruned scan's phase A, the elastic repad, a rebuild's
build/swap halves. Spans NEST through a thread-local stack (each record
carries its parent's name path and depth), and completed records land in
a process-global RING BUFFER (`deque(maxlen=...)`): a serving process
keeps the most recent few thousand spans for a dashboard or post-mortem
without unbounded growth.

Spans are DISABLED by default and the hot path stays out of their way:
`span(...)` with tracing off returns a shared no-op context manager — one
module-global check, no allocation, no clock read — which is what the
≤ 1.03× instrumented-serving overhead gate requires. Enable with
`enable()` (or the `REPRO_OBS_SPANS=1` env var at import), and pass
`profiler=True` to additionally wrap every span in a
`torch.profiler.record_function`, so HOST spans line up with DEVICE
kernels in a `torch.profiler` trace (the import is deferred, so this
module stays stdlib-only until a span asks for it).

Cross-thread intervals (a queue wait measured at dispatch for a request
submitted on a client thread) cannot be a `with` block; `event()` records
one retroactively from (t_start, duration).

Usage::

    from repro_torch.obs import trace

    trace.enable()
    with trace.span("serve.tick", batch=16) as sp:
        ...
        sp.set(epoch=snap.epoch)        # attrs may land mid-span
    trace.spans("serve.tick")           # recent completed records
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

__all__ = ["SpanRecord", "span", "event", "enable", "disable",
           "is_enabled", "spans", "clear", "set_capacity"]

_enabled = False
_profiler = False
_tls = threading.local()
_lock = threading.Lock()                # guards buffer swaps only
_buffer: Deque["SpanRecord"] = deque(maxlen=4096)


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed span (immutable; safe to hand to dashboards)."""

    name: str
    t_start: float                      # time.monotonic() at entry
    duration_s: float
    depth: int                          # 0 = top-level on its thread
    parent: Optional[str]               # enclosing span's name, if any
    thread: str
    attrs: Tuple[Tuple[str, object], ...] = ()

    @property
    def duration_ms(self) -> float:
        return self.duration_s * 1e3


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL = _NullSpan()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


class _Span:
    __slots__ = ("name", "attrs", "t0", "_prof")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        self._prof = None
        if _profiler:
            import torch.profiler
            self._prof = torch.profiler.record_function(self.name)
            self._prof.__enter__()
            # host and device timelines align because the annotation
            # brackets exactly this span's body
        _stack().append(self.name)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        stack = _stack()
        # tolerate enable()/disable() races mid-span: only pop our frame
        if stack and stack[-1] is self.name:
            stack.pop()
        depth = len(stack)
        parent = stack[-1] if stack else None
        if self._prof is not None:
            self._prof.__exit__(*exc)
        _buffer.append(SpanRecord(
            name=self.name, t_start=self.t0, duration_s=t1 - self.t0,
            depth=depth, parent=parent,
            thread=threading.current_thread().name,
            attrs=tuple(sorted(self.attrs.items()))))
        return False


def span(name: str, **attrs):
    """A context manager timing `name`; no-op (shared null object) while
    tracing is disabled."""
    if not _enabled:
        return _NULL
    return _Span(name, attrs)


def event(name: str, t_start: float, duration_s: float, **attrs) -> None:
    """Record a RETROACTIVE span — an interval measured across threads
    (e.g. a request's submit→dispatch queue wait, timed on the dispatcher
    thread from the client thread's submit timestamp). It is attributed
    to the calling thread's current span stack."""
    if not _enabled:
        return
    stack = _stack()
    _buffer.append(SpanRecord(
        name=name, t_start=t_start, duration_s=duration_s,
        depth=len(stack), parent=stack[-1] if stack else None,
        thread=threading.current_thread().name,
        attrs=tuple(sorted(attrs.items()))))


def enable(profiler: bool = False) -> None:
    """Turn span recording on; `profiler=True` additionally opens a
    `torch.profiler.record_function` per span so device traces line up."""
    global _enabled, _profiler
    _profiler = bool(profiler)
    _enabled = True


def disable() -> None:
    global _enabled, _profiler
    _enabled = False
    _profiler = False


def is_enabled() -> bool:
    return _enabled


def spans(name: Optional[str] = None) -> List[SpanRecord]:
    """Completed spans currently in the ring buffer, oldest first;
    optionally filtered by exact name."""
    with _lock:
        out = list(_buffer)
    if name is not None:
        out = [s for s in out if s.name == name]
    return out


def clear() -> None:
    with _lock:
        _buffer.clear()


def set_capacity(n: int) -> None:
    """Resize the ring buffer (keeps the most recent records)."""
    global _buffer
    if n < 1:
        raise ValueError(f"span buffer capacity must be >= 1; got {n}")
    with _lock:
        _buffer = deque(_buffer, maxlen=int(n))


if os.environ.get("REPRO_OBS_SPANS", "").strip() in ("1", "true", "on"):
    enable(profiler=os.environ.get("REPRO_OBS_PROFILER", "").strip()
           in ("1", "true", "on"))
