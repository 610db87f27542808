"""roofline_pct.lm_kernels (%): Σ bound / Σ device time over every call
of kernels 7 (flash attention, forward) and 8 (RMSNorm, forward) in the
profiled round.  The driver keeps each call's arguments' shapes, in call
order, through the port's public wrappers ``ops.flash_attention`` and
``ops.rmsnorm``; the device time is that of the kernels of those names
in the round.
The bound of a call is max(bytes / 3.35 TB/s, operations / 67 TFLOP/s):
flash attention's q, k, v and o once and the causal half's two
products, RMSNorm's x and y once and its 4 operations an element."""
from bench.roofline import counts
from bench.roofline.peaks import bound_s


def _kernels(p, part):
    n = t = 0
    for name, (c, s) in p.ops_by_name.items():
        if part in name:
            n, t = n + c, t + s
    return n, t


def read(ctx):
    p = ctx.profiled
    calls = getattr(ctx, "calls", None)
    if p is None or not calls:
        return None
    bound = time = 0.0
    for part in ("flash_attention", "rmsnorm"):
        mine = [c for c in calls if c[0] == part]
        time += _kernels(p, part)[1]
        for call in mine:
            if part == "flash_attention":
                (b, hq, s, hd), (_, hk, _, _), causal = call[1:]
                bound += bound_s(*counts.flash_attention_gqa(
                    b, hq, hk, s, hd, causal))
            else:
                shape = call[1]
                rows = 1
                for d in shape[:-1]:
                    rows *= d
                bound += bound_s(*counts.rmsnorm(rows, shape[-1]))
    if time <= 0:
        return None
    return 100.0 * bound / time
