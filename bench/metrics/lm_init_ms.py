"""lm_init_ms (ms): stream time of the LM launcher's ``lm_init`` span
(the model built and its weights drawn, the silos drawn, the
capabilities and the deadline), its ``dev_s`` summed over the traced
window and divided by its calls."""


def read(ctx):
    dev = [r.get("dev_s") for r in ctx.spans if r.get("kind") == "span"
           and r.get("name") == "lm_init"]
    dev = [d for d in dev if d is not None]
    if not dev:
        return None
    return 1e3 * sum(dev) / len(ctx.walls)
