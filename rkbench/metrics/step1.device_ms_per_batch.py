"""step1.device_ms_per_batch: the device time per batch of what the
program launches inside its `query.step1` span (K1 or K5 and step 1's
preamble: the checks, ‖q‖₁ at int8), in the traced slice."""

SPAN = "query.step1"


def read(ctx):
    t = ctx["trace"]
    if not t or SPAN not in t["span_calls"]:
        return None
    return 1e3 * t["span_device_s"].get(SPAN, 0.0) / t["batches"]
