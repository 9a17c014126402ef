"""step1.roofline_pct: step 1's least time on the H100 (the storage's
`step1` count, its 12·n·B bytes of bounds included) over the device time
per batch of the step-1 kernel (K1 or K5: the ring kernel, by name)."""

KERNEL = "step1_ring_kernel"


def read(ctx):
    t = ctx["trace"]
    step1 = sum(s for name, s in t["device_s_by_name"].items()
                if KERNEL in name) if t else 0.0
    if step1 <= 0:
        return None
    return 100.0 * ctx["least_step1_s"] / (step1 / t["batches"])
