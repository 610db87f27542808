"""idle_pct (%): 1 − the card's busy time in the profiled round (the
union of its kernel, copy and fill intervals) over an unprofiled round's
wall (the traced window's mean round)."""


def read(ctx):
    p = ctx.profiled
    if p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / ctx.round_s)
