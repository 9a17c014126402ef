"""The traced slice of a window: `torch.profiler` on the host and the
card, spans from the benchmark's own files, and its reduction to device
time by kernel, the device's busy time, and the idle gaps by what the
host was doing.

Spans (`record_function`, only while tracing): `rkbench.batch` around a
batch, inside it `rkbench.query_batch` (the call into the engine) and
`rkbench.answer_to_host` (the copy of the answer that ends the batch);
the program's own spans (`repro_torch.obs.trace`, switched on with its
profiler hook in a traced run) beside them. A per-layer metric reads the
device time of a kernel by name (`device_s_by_name`) or under a span
(`span_device_s`).
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

SPAN = "rkbench.batch"
TOP = 10
NAME_CHARS = 160


class Tracer:
    """Profiles the host and the card between `start` and `stop`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.on = False

    def start(self):
        self.prof.start()
        self.on = True

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.on = False

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


def _is_memory_op(name: str) -> bool:
    """A copy or fill on the device, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(tracer: Tracer) -> dict:
    """`summarize` over the profiler's events."""
    host, device = [], []
    for e in tracer.prof.profiler.kineto_results.events():
        a, b, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((a, b, name, e.start_thread_id(), e.correlation_id(),
                         e.linked_correlation_id(), e.is_user_annotation()))
        elif b > a:
            device.append((a, b, name, e.correlation_id(),
                           e.linked_correlation_id(), e.is_user_annotation()))
    return summarize(host, device)


def _latest_at_or_before(starts: list[int], t: int) -> int:
    """Index of the last of the sorted `starts` at or before t, or -1."""
    return bisect.bisect_right(starts, t) - 1


def span_device_seconds(host: list[tuple], device: list[tuple],
                        device_spans: list[tuple], w0: int, w1: int
                        ) -> tuple[dict, dict, dict]:
    """Device seconds of the operations launched inside each span, by span
    name, and the spans' count, over the spans in [w0, w1); and the device
    seconds, by operation name, that no span holds.

    A device operation's launch is the runtime call that shares its
    correlation id (`cudaLaunchKernel`, `cudaMemcpyAsync`, ...), else the
    host operation it links to (the innermost one running when it was
    launched); it counts for every span on that thread around the
    launch, so nested spans each hold their inner spans' time. A kernel
    whose launch the profiler did not record (the port's own kernels,
    launched through ctypes from a library of their own) is put at the
    start of the host span whose range on the device timeline
    (`device_spans`: the innermost span's, from the first to the last
    operation launched in it) holds its middle: the span of that name
    that started last before the range did."""
    runtime = {corr: (a, thread) for a, _, _, thread, corr, linked, _
               in host if linked != 0}
    frontend = {corr: (a, thread) for a, _, _, thread, corr, linked, _
                in host if linked == 0}
    opened: dict[str, tuple[list[int], list[int]]] = {}
    for a, _, name, thread, *_, annotation in sorted(host):
        if annotation:
            starts, threads = opened.setdefault(name, ([], []))
            starts.append(a)
            threads.append(thread)
    ranges: dict[str, tuple[list[int], list[int]]] = {}
    for a, b, name in sorted(device_spans):
        starts, ends = ranges.setdefault(name, ([], []))
        starts.append(a)
        ends.append(b)

    def by_range(t: int):
        held = []
        for name, (starts, ends) in ranges.items():
            i = _latest_at_or_before(starts, t)
            if i >= 0 and ends[i] >= t:
                held.append((starts[i], name))
        if not held:
            return None
        r0, name = max(held)                    # the innermost range
        starts, threads = opened.get(name, ([], []))
        i = _latest_at_or_before(starts, r0)
        return (starts[i], threads[i]) if i >= 0 else None

    per_thread: dict[int, list[tuple[int, float]]] = defaultdict(list)
    unheld: dict[str, float] = defaultdict(float)
    for a, b, name, corr, linked in device:
        at = runtime.get(corr) or frontend.get(linked) or by_range(
            (a + b) // 2)
        if at is None:
            unheld[name] += (b - a) * 1e-9
        else:
            t, thread = at
            per_thread[thread].append((t, (b - a) * 1e-9))
    sums: dict[int, tuple[list[int], list[float]]] = {}
    for thread, pts in per_thread.items():
        pts.sort()
        acc, total = [0.0], 0.0
        for _, s in pts:
            total += s
            acc.append(total)
        sums[thread] = ([t for t, _ in pts], acc)
    seconds: dict[str, float] = defaultdict(float)
    calls: dict[str, int] = defaultdict(int)
    for a, b, name, thread, _, _, annotation in host:
        if not annotation or a < w0 or b > w1:
            continue
        calls[name] += 1
        if thread in sums:
            ts, acc = sums[thread]
            seconds[name] += acc[bisect.bisect_left(ts, b)] \
                - acc[bisect.bisect_left(ts, a)]
    return dict(seconds), dict(calls), dict(unheld)


def summarize(host: list[tuple], device: list[tuple]) -> dict:
    """Over the window that the traced `rkbench.batch` spans cover: device
    time by operation name (all of them, and the top ones), kernels
    apart; the union of device activity in it (busy), and its idle gaps,
    each named by the innermost host operation or span running at the
    gap's start; device time by enclosing span (`span_device_seconds`).
    `host` holds (start_ns, end_ns, name, thread, correlation id, linked
    correlation id, is a span), `device` (start_ns, end_ns, name,
    correlation id, linked correlation id, is a span); a device event
    that is a span, or bears a host span's name, is the span's range on
    the device timeline and no operation. Times in seconds."""
    batches = [(a, b) for a, b, name, *_ in host if name == SPAN]
    if not batches:
        return {}
    w0, w1 = min(a for a, _ in batches), max(b for _, b in batches)
    span_names = {name for _, _, name, *_, annotation in host if annotation}
    device_spans = [(a, b, name) for a, b, name, *_, annotation in device
                    if annotation or name in span_names]
    clipped = [(max(a, w0), min(b, w1), name, *rest)
               for a, b, name, *rest, annotation in device
               if b > w0 and a < w1
               and not (annotation or name in span_names)]
    by_name: dict[str, float] = defaultdict(float)
    kernel_s = 0.0
    for a, b, n, *_ in clipped:
        s = (b - a) * 1e-9
        by_name[n] += s
        if not _is_memory_op(n):
            kernel_s += s
    busy = _union([(a, b) for a, b, *_ in clipped])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    ops = sorted((a, b, name) for a, b, name, *_ in host if b > a)
    starts = [a for a, _, _ in ops]
    idle: dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        name = "host: no operation"
        i = bisect.bisect_right(starts, g0) - 1
        while i >= 0:
            if ops[i][1] > g0:          # the latest-starting op around g0
                name = f"host: {ops[i][2]}"
                break
            i -= 1
        idle[name] += (g1 - g0) * 1e-9
    span_s, span_calls, unheld = span_device_seconds(
        host, clipped, device_spans, w0, w1)
    top = lambda d: [[k[:NAME_CHARS], v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"batches": len(batches), "window_s": (w1 - w0) * 1e-9,
            "busy_s": busy_s, "kernel_s": kernel_s,
            "device_s_by_name": dict(by_name),
            "span_device_s": span_s, "span_calls": span_calls,
            "unheld_s": top(unheld),
            "device_ops": top(by_name), "idle_gaps": top(idle)}
