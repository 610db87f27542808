"""launches_per_round (launches): CUDA kernels the profiled round ran on
the card."""


def read(ctx):
    p = ctx.profiled
    if p is None or p.launches <= 0:
        return None
    return float(p.launches)
