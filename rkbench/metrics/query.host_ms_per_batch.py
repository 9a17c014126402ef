"""query.host_ms_per_batch: the median host time of a batch inside the
program, from the backend's entry to its return (the program's own
`query.batch` span records, `repro_torch.obs.trace`, in the ring buffer
after the window: the window's last batches, past the traced slice)."""
import statistics

SPAN = "query.batch"


def read(ctx):
    if ctx.get("trace") is None:
        return None         # not a traced run: the program's spans were off
    from repro_torch.obs import trace
    recs = trace.spans(SPAN)
    if not recs:
        return None
    return 1e3 * statistics.median(r.duration_s for r in recs)
