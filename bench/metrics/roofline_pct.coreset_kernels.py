"""roofline_pct.coreset_kernels (%): Σ bound / Σ device time over every
call of the coreset kernels 2–6 in the profiled round.

Device time: the kernels of the port's coreset sources (names holding
``pairwise_l2``, ``build_cost``, ``delta_sweep`` or ``from_feats``)
inside the round's ``selection`` ranges.  Calls: the program's own
launch counter (``repro_torch.kernels.ops.LAUNCHES``, one a call) over
the round, split over the straggler groups (the i-th ``selection`` range
is the i-th straggler group of the driver's list): one kernel-4 call a
group below the cutover, k BUILD calls a group (kernel 2 below, 5 at or
above), and the Δ-sweep calls (kernel 3 below, 6 at or above) in
proportion to the launches of the sweep's own device kernel
(``delta_sweep_segments``, ``from_feats_sweep_product``) in each range,
per piece of a distance-free call.  A call's bound is max(bytes /
3.35 TB/s, operations / 67 TFLOP/s) at its group's (C, M, F, k)
(``bench/roofline/counts.py``)."""
from bench.roofline import counts
from bench.roofline.peaks import bound_s

PARTS = ("pairwise_l2", "build_cost", "delta_sweep", "from_feats")


def _launches(by_kernel, part):
    return sum(v[0] for n, v in by_kernel.items() if part in n)


def read(ctx):
    p = ctx.profiled
    ranges = p.ranges.get("selection", []) if p is not None else []
    stragglers = [g for g in ctx.groups if g[1] > 0]
    if not ranges or len(ranges) != len(stragglers):
        return None
    f = ctx.feature_width
    time = sum(v[1] for r in ranges for n, v in r.by_kernel.items()
               if any(part in n for part in PARTS))
    # the sweeps' share of each group, from its own sweep kernel's launches
    share = []
    for (m, k, c), r in zip(stragglers, ranges):
        if m >= ctx.config["materialize_below"]:
            pieces = len(counts.from_feats_pieces(c, m))
            share.append(("delta_sweep_from_feats", _launches(
                r.by_kernel, "from_feats_sweep_product") / pieces))
        else:
            share.append(("delta_sweep", _launches(r.by_kernel,
                                                   "delta_sweep_segments")))
    totals = {}
    for name, s in share:
        totals[name] = totals.get(name, 0.0) + s
    bound = 0.0
    for (m, k, c), (name, s) in zip(stragglers, share):
        nnz = float(c * m)
        sweeps = (ctx.launches.get(name, 0) * s / totals[name]
                  if totals[name] else 0.0)
        if name == "delta_sweep_from_feats":
            bound += k * bound_s(*counts.build_cost_from_feats(c, m, f))
            bound += sweeps * bound_s(*counts.delta_sweep_from_feats(
                c, m, f, k, nnz))
        else:
            bound += bound_s(*counts.pairwise_l2_batched(c, m, f))
            bound += k * bound_s(*counts.build_cost(c, m))
            bound += sweeps * bound_s(*counts.delta_sweep(c, m, k, nnz))
    if time <= 0:
        return None
    return 100.0 * bound / time
