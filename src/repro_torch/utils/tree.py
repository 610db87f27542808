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



def tree_add(a: Params, b: Params) -> Params:
    """Leaf-wise ``a + b`` into new tensors (neither input is changed)."""
    return {k: a[k] + b[k] for k in a}


def tree_sub(a: Params, b: Params) -> Params:
    """Leaf-wise ``a - b`` into new tensors (neither input is changed)."""
    return {k: a[k] - b[k] for k in a}


def tree_scale(a: Params, s) -> Params:
    """Leaf-wise ``a * s`` into new tensors (``a`` is not changed)."""
    return {k: v * s for k, v in a.items()}


def reference_keys(keys) -> list:
    """``keys`` in the JAX package's leaf order: ``jax.tree.flatten``
    sorts dict keys at every level of the nested tree the dotted names
    stand for."""
    return sorted(keys, key=lambda k: tuple(k.split(".")))


def reference_leaves(params: Params, layouts=None, lead: int = 0) -> list:
    """The leaves of ``params`` in the JAX package's order and layout:
    each leaf named in ``layouts`` (a model's ``reference_layouts``) has
    its axes permuted into the JAX layout, after ``lead`` leading axes
    (a client axis of a stacked tree) that stay in place."""
    layouts = layouts or {}
    out = []
    for k in reference_keys(params):
        x = params[k]
        if k in layouts:
            x = x.permute(*range(lead), *(lead + a for a in layouts[k]))
        out.append(x)
    return out
