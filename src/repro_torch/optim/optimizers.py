"""The port's optimiser: plain SGD over flat parameter dicts.

An ``Optimizer`` is an (init, update) pair, as in the JAX package:

    opt = sgd(0.03)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = tree_add(params, updates)

Only the momentum-free SGD the FL runtime uses is ported; its update is
``-lr * g`` with ``lr`` rounded to float32 first, so ``p + update`` is
bit for bit ``p - lr*g`` as the reference computes it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {"step": 0}

    def update(grads, state, params=None):
        first = next(iter(grads.values()))
        lr_t = torch.tensor(lr, dtype=torch.float32, device=first.device)
        return ({k: g * -lr_t for k, g in grads.items()},
                {"step": state["step"] + 1})

    return Optimizer(init, update)
