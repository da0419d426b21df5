"""step.busy_ms_per_step (ms/step): the card's busy time (the union of
its activities in the device trace) a compiled step, over the traced
stretch."""

SOURCE = "device_trace"


def read(ctx):
    t = ctx["trace"]
    if not t or not t["steps"] or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["steps"]
