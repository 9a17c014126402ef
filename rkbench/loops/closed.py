"""One client in a closed loop: it submits a batch as soon as the previous
batch's answer (top-k user ids and their estimated ranks) is on the host.
"""
from __future__ import annotations

import contextlib
import gc
import time


def run(state: dict, traffic: dict, seconds: float, tracer=None) -> dict:
    """Drive `state["program"](qs) -> (indices, est)` (device tensors) with
    the batches `state["qv"][i % P]` for `seconds` seconds. With a
    `tracer`, its profiler covers the window's first
    `traffic["trace_batches"]` batches.

    Returns each batch's latency (submission to answer on the host) and
    answer, the batches answered inside the window, and its length.

    The cyclic garbage collector is off in the window (what set-up made
    is frozen out of its reach): its passes over the growing list of
    answers would stall the client more and more as the window goes on."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        return _window(state["program"], state["qv"], seconds, tracer,
                       traffic["trace_batches"] if tracer is not None else 0)
    finally:
        gc.enable()
        gc.unfreeze()


def _window(program, queries, seconds, tracer, trace_batches):
    span = (tracer.span if tracer is not None
            else lambda name: contextlib.nullcontext())
    pool = queries.shape[0]
    latencies, answers = [], []
    answered = 0
    if trace_batches:
        tracer.start()
    t_end = time.perf_counter() + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        with span("rkbench.batch"):
            with span("rkbench.query_batch"):
                idx, est = program(queries[i % pool])
            with span("rkbench.answer_to_host"):
                idx, est = idx.cpu(), est.cpu()
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        answers.append((idx, est))
        answered += t1 <= t_end
        i += 1
        if tracer is not None and tracer.on and i == trace_batches:
            tracer.stop()
    if tracer is not None and tracer.on:
        tracer.stop()
    return {"latencies_s": latencies, "answers": answers,
            "answered_in_window": answered, "window_s": seconds}
