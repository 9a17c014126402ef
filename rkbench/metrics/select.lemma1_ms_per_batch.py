"""select.lemma1_ms_per_batch: the device time per batch inside the
program's `select.lemma1` span (the Lemma-1 masks and key, and the stable
sort of all n keys), in the traced slice."""

SPAN = "select.lemma1"


def read(ctx):
    t = ctx["trace"]
    if not t or SPAN not in t["span_calls"]:
        return None
    return 1e3 * t["span_device_s"].get(SPAN, 0.0) / t["batches"]
