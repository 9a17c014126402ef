"""device.idle_pct: the share of the traced slice's wall time in which no
operation ran on the card (torch.profiler's device timeline)."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
