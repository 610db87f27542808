"""lm_call_s (s): the window's time over the whole calls of the LM
launcher (``train_fedcore_lm(rounds=1)``) it completed, each ending in
``torch.cuda.synchronize()``.  A call draws its weights and silos anew
before its round (about 1 s of 9 on an H100), so this is a round with
its launcher's start, not a round alone."""


def read(ctx):
    return ctx.round_s
