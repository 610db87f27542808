"""The port's optimisers over flat parameter dicts.

An ``Optimizer`` is an (init, update) pair, as in the JAX package:

    opt = adam(3e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = tree_add(params, updates)

Learning rates may be floats or callables step -> lr (``schedules``).
The step counter is an int32 scalar tensor on the CPU, as the schedules
read it; a schedule's lr and Adam's bias corrections are float32
scalars on the CPU too, so a step on the card waits on no copy.
The update of a float ``lr`` is ``-lr * g`` with ``lr`` rounded to
float32 first, so ``p + update`` is bit for bit ``p - lr*g`` as the
reference computes it (the FL runtimes' parity depends on it).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.utils.tree import global_norm, tree_scale, tree_zeros_like

LR = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _lr_at(lr: LR, step: torch.Tensor, device) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.full((), lr, dtype=torch.float32, device=device)


def _device(tree):
    return next(iter(tree.values())).device


def sgd(lr: LR, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        state = {"step": _step0()}
        if momentum:
            state["mu"] = tree_zeros_like(params)
        return state

    def update(grads, state, params=None):
        step = state["step"]
        lr_t = _lr_at(lr, step, _device(grads))
        if momentum:
            mu = {k: momentum * state["mu"][k] + g for k, g in grads.items()}
            if nesterov:
                upd = {k: -lr_t * (momentum * mu[k] + g)
                       for k, g in grads.items()}
            else:
                upd = tree_scale(mu, -lr_t)
            return upd, {"step": step + 1, "mu": mu}
        return ({k: g * -lr_t for k, g in grads.items()},
                {"step": step + 1})

    return Optimizer(init, update)


def adam(lr: LR, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return _adam_impl(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return _adam_impl(lr, b1, b2, eps, weight_decay)


def _adam_impl(lr: LR, b1, b2, eps, weight_decay) -> Optimizer:
    def init(params):
        return {"step": _step0(), "m": tree_zeros_like(params),
                "v": tree_zeros_like(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, state["step"], torch.device("cpu"))
        m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(g)
             for k, g in grads.items()}
        t = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), t)
        updates = {}
        for k in grads:
            u = -lr_t * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
            if weight_decay and params is not None:
                u = u - lr_t * weight_decay * params[k]
            updates[k] = u
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    """(grads · min(1, max_norm / max(‖grads‖, 1e-9)), ‖grads‖), the norm
    a float32 scalar on the grads' device (``utils.tree.global_norm``)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_scale(grads, scale), norm
