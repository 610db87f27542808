"""group_body_ms (ms): device time of the operations launched inside the
program's ``local_sgd`` and ``coreset_group`` ranges (the fleet group
body: vmapped SGD, and for stragglers their features, selection and
coreset epochs), in the profiled round."""


def read(ctx):
    p = ctx.profiled
    if p is None or not (p.ranges.get("local_sgd")
                         or p.ranges.get("coreset_group")):
        return None
    ms = 1e3 * p.range_device_s("local_sgd", "coreset_group")
    return ms if ms > 0 else None
