"""select.ms_per_batch: the device time per batch of every kernel in the
traced slice other than the step-1 kernel: the selection (sorts, top-k,
the Lemma-1 keys) and the other elementwise work of the query."""

KERNEL = "step1_ring_kernel"


def read(ctx):
    t = ctx["trace"]
    if not t or t["kernel_s"] <= 0:
        return None
    step1 = sum(s for name, s in t["device_s_by_name"].items()
                if KERNEL in name)
    return 1e3 * (t["kernel_s"] - step1) / t["batches"]
