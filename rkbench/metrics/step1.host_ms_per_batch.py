"""step1.host_ms_per_batch: the median host time of a batch's step 1
(the program's own `query.step1` span records, `repro_torch.obs.trace`,
in the ring buffer after the window): the host work before and between
the step-1 launches, which the card waits on at a batch's start."""
import statistics

SPAN = "query.step1"


def read(ctx):
    if ctx.get("trace") is None:
        return None         # not a traced run: the program's spans were off
    from repro_torch.obs import trace
    recs = trace.spans(SPAN)
    if not recs:
        return None
    return 1e3 * statistics.median(r.duration_s for r in recs)
