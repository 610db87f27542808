"""Helpers over flat parameter dicts."""
from repro_torch.utils.tree import (  # noqa: F401
    tree_add,
    tree_scale,
    tree_sub,
    tree_weighted_mean,
    tree_zeros_like,
    global_norm,
    param_count,
    tree_allclose,
)
