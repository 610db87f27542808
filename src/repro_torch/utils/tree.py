"""Helpers over flat parameter dicts (``dict[str, Tensor]``).

The JAX package moves pytrees of arrays; the port moves flat dicts whose
keys are the JAX tree paths joined with ``.`` (``lstm0.wx``), the same
names ``nn.Module.named_parameters`` gives.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

Params = Dict[str, torch.Tensor]


def tree_weighted_mean(trees: Sequence[Params],
                       weights: Sequence[float]) -> Params:
    """FedAvg-style aggregation: sum_i w_i * tree_i / sum_i w_i.

    Same summation order as the JAX package: the float32 weights are
    normalised first, then each leaf is ``out + leaf_i * w_i`` from left
    to right."""
    first = next(iter(trees[0].values()))
    ws = torch.as_tensor(weights, dtype=torch.float32, device=first.device)
    ws = ws / torch.sum(ws)
    out = {}
    for k in trees[0]:
        acc = trees[0][k] * ws[0]
        for i in range(1, len(trees)):
            acc = acc + trees[i][k] * ws[i]
        out[k] = acc
    return out

