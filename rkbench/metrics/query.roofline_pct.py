"""query.roofline_pct: a query batch's least time on the H100 (the larger
of its least bytes over 3.35 TB/s and its f32 operations over 67 TFLOP/s,
`counts.query`) over the device time of every kernel in the traced slice,
per batch."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["kernel_s"] <= 0:
        return None
    return 100.0 * ctx["least_query_s"] / (t["kernel_s"] / t["batches"])
