"""selection_ms (ms): device time of the operations launched inside the
program's ``selection`` ranges (the coreset's k-medoids solves), in the
profiled round."""


def read(ctx):
    p = ctx.profiled
    if p is None or not p.ranges.get("selection"):
        return None
    ms = 1e3 * p.range_device_s("selection")
    return ms if ms > 0 else None
