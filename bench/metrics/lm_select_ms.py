"""lm_select_ms (ms): stream time of the LM launcher's straggler
selection, its ``grad_features`` spans (the feature pass) and
``selection`` spans (k-medoids and the coreset's batch), their ``dev_s``
summed over the traced window and divided by its calls."""


def read(ctx):
    dev = [r.get("dev_s") for r in ctx.spans if r.get("kind") == "span"
           and r.get("name") in ("grad_features", "selection")]
    dev = [d for d in dev if d is not None]
    if not dev:
        return None
    return 1e3 * sum(dev) / len(ctx.walls)
