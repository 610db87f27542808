"""cohort_build_ms (ms): the program's ``cohort_build`` span (the fleet
round loop's grouping and padding of the cohort on the host), summed
over the traced window and divided by its rounds."""


def read(ctx):
    durs = [r["dur"] for r in ctx.spans
            if r.get("kind") == "span" and r.get("name") == "cohort_build"]
    if not durs:
        return None
    return 1e3 * sum(durs) / len(ctx.walls)
