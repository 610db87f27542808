"""sgd_step_ms (ms): the host's time a step of the fleet's vmapped SGD:
the program's ``sgd_steps`` spans (a group's mini-batch epochs) and
``coreset_epochs`` spans (a straggler group's coreset epochs), their
host durations summed over the traced window and divided by the steps
they stamp.  The host clock on purpose: the host paces these steps, so
its time a step is the round's pace."""


def read(ctx):
    spans = [r for r in ctx.spans if r.get("kind") == "span"
             and r.get("name") in ("sgd_steps", "coreset_epochs")]
    steps = sum(r["attrs"].get("steps", 0) for r in spans)
    if not steps:
        return None
    return 1e3 * sum(r["dur"] for r in spans) / steps
