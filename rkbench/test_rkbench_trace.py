"""The trace's reduction on made-up events: device time by kernel, busy
and idle time, and device time under each enclosing span, attributed by
the host operation that launched it."""
import pytest

from rkbench import trace

NS = 1e-9
# (start_ns, end_ns, name, thread, correlation id, linked id, is a span)
HOST = [
    (0, 100, "rkbench.batch", 1, 1, 0, True),
    (0, 60, "rkbench.query_batch", 1, 2, 0, True),
    (10, 20, "aten::sort", 1, 3, 0, False),
    (12, 13, "cudaLaunchKernel", 1, 50, 3, False),
    (61, 62, "cudaLaunchKernel", 1, 52, 6, False),  # stale link; see 52
    (30, 50, "engine.delta_correct", 1, 4, 0, True),
    (35, 40, "aten::add", 1, 5, 0, False),
    (60, 100, "rkbench.answer_to_host", 1, 6, 0, True),
    (65, 70, "aten::copy_", 1, 7, 0, False),
    (20, 90, "other.thread", 2, 8, 0, True),
]
# (start_ns, end_ns, name, correlation id, linked id, is a span)
DEVICE = [
    (20, 40, "sort_kernel", 50, 3, False),      # its runtime call, in sort
    (40, 50, "add_kernel", 51, 5, False),
    (45, 48, "custom_kernel", 52, 4, False),    # its runtime call wins
    (70, 80, "Memcpy DtoH (Device -> Pageable)", 53, 7, False),
    (80, 82, "lost_kernel", 54, 0, False),      # no launch on record
    (90, 92, "stray_kernel", 55, 0, False),     # nor any span around it
    (120, 130, "after_the_window", 56, 5, False),
    # the innermost spans' ranges on the device timeline: flagged, or by
    # name; none for rkbench.batch, which launches nothing itself
    (20, 50, "rkbench.query_batch", 0, 0, True),
    (70, 82, "rkbench.answer_to_host", 0, 0, False),
]


def test_device_time_by_kernel_busy_and_idle():
    t = trace.summarize(HOST, DEVICE)
    assert t["batches"] == 1
    assert t["window_s"] == pytest.approx(100 * NS)
    assert t["kernel_s"] == pytest.approx(37 * NS)      # no copy, no span
    assert t["device_s_by_name"]["sort_kernel"] == pytest.approx(20 * NS)
    assert "after_the_window" not in t["device_s_by_name"]
    assert "rkbench.query_batch" not in t["device_s_by_name"]
    assert t["busy_s"] == pytest.approx(44 * NS)    # [20, 50] [70, 82] [90, 92]
    assert sum(s for _, s in t["idle_gaps"]) == pytest.approx(56 * NS)


def test_device_time_under_each_span():
    t = trace.summarize(HOST, DEVICE)
    span = {k: v / NS for k, v in t["span_device_s"].items()}
    # custom_kernel's runtime call (at 61) wins over its link (at 30);
    # lost_kernel goes to the start of the answer span whose device range
    # holds it, so to rkbench.batch around that too
    assert span["rkbench.batch"] == pytest.approx(45)
    assert span["rkbench.query_batch"] == pytest.approx(30)
    assert span["engine.delta_correct"] == pytest.approx(10)
    assert span["rkbench.answer_to_host"] == pytest.approx(15)
    assert t["unheld_s"] == [["stray_kernel", pytest.approx(2 * NS)]]
    assert span.get("other.thread", 0.0) == 0.0     # another thread's
    assert t["span_calls"]["engine.delta_correct"] == 1


def test_nothing_to_read_without_a_batch_span():
    assert trace.summarize([h for h in HOST if h[2] != trace.SPAN],
                           DEVICE) == {}
