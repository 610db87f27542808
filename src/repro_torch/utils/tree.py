"""Helpers over flat parameter dicts (``dict[str, Tensor]``).

The JAX package moves pytrees of arrays; the port moves flat dicts whose
keys are the JAX tree paths joined with ``.`` (``lstm0.wx``), the same
names ``nn.Module.named_parameters`` gives.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
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


def tree_zeros_like(a: Params) -> Params:
    """Leaf-wise zeros of each leaf's shape, dtype and device."""
    return {k: torch.zeros_like(v) for k, v in a.items()}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt(Σ over leaves of Σx²) in float32, the leaves' sums added in
    the JAX package's leaf order (``reference_keys``), as its
    ``global_norm`` adds the sums of ``jax.tree.leaves``."""
    total = 0
    for k in reference_keys(tree):
        total = total + torch.sum(torch.square(tree[k].float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def param_count(tree: Params) -> int:
    return int(sum(v.numel() for v in tree.values()))


def tree_allclose(a: Params, b: Params, rtol=1e-5, atol=1e-6) -> bool:
    """Same keys, and every leaf of ``a`` within ``np.allclose`` of
    ``b``'s."""
    if sorted(a) != sorted(b):
        return False
    return all(np.allclose(a[k].detach().cpu().numpy(),
                           b[k].detach().cpu().numpy(), rtol=rtol, atol=atol)
               for k in a)


def split_keys(generator: torch.Generator, n: int) -> List[torch.Generator]:
    """``n`` child generators on ``generator``'s device, each seeded with
    one draw of ``generator``: the counterpart of ``jax.random.split``,
    which it does not replay (the port's draws are not the JAX
    package's; the parity tests convert the JAX init instead)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                          device=generator.device)
    return [torch.Generator(device=generator.device).manual_seed(int(s))
            for s in seeds.tolist()]
