"""kmedoids_swap_ms (ms): stream time of the program's ``kmedoids_swap``
spans (k-medoids SWAP: its sweeps, one host round trip each), their
``dev_s`` summed over the traced window and divided by its rounds."""


def read(ctx):
    dev = [r.get("dev_s") for r in ctx.spans if r.get("kind") == "span"
           and r.get("name") == "kmedoids_swap"]
    dev = [d for d in dev if d is not None]
    if not dev:
        return None
    return 1e3 * sum(dev) / len(ctx.walls)
