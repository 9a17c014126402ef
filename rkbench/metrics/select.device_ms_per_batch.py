"""select.device_ms_per_batch: the device time per batch of what the
program launches inside its `query.select` span (`select_topk`: the two
order statistics, the Lemma-1 key and its sort, the answer's gather and
counts), in the traced slice."""

SPAN = "query.select"


def read(ctx):
    t = ctx["trace"]
    if not t or SPAN not in t["span_calls"]:
        return None
    return 1e3 * t["span_device_s"].get(SPAN, 0.0) / t["batches"]
