"""Optimisers and learning-rate schedules over flat parameter dicts."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    sgd,
    adam,
    adamw,
    clip_by_global_norm,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_lr,
    cosine_lr,
    inverse_time_lr,
    warmup_cosine_lr,
)
