"""select.kth_ms_per_batch: the device time per batch inside the
program's `select.kth` span (the two `kth_smallest` calls, with the
copies of step 1's user-major outputs that they make), in the traced
slice."""

SPAN = "select.kth"


def read(ctx):
    t = ctx["trace"]
    if not t or SPAN not in t["span_calls"]:
        return None
    return 1e3 * t["span_device_s"].get(SPAN, 0.0) / t["batches"]
