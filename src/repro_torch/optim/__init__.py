"""Optimisers over flat parameter dicts."""
from repro_torch.optim.optimizers import Optimizer, sgd  # noqa: F401
