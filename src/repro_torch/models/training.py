"""Train / eval step factories over flat parameter dicts.

Works for the paper's small FL models and for the decoder ``Model``:
anything exposing ``loss(params, batch) -> (scalar, metrics)``.
``make_train_step(loss_fn, optimizer, ...)`` returns
``step(params, opt_state, batch, prox_ref=None) -> (params, opt_state,
metrics)``.  Gradients come from autograd through plain PyTorch layers
and the kernels' autograd Functions, as the JAX package takes
``jax.grad`` through XLA.

FedProx support: ``prox_mu > 0`` adds (mu/2)||w - w_ref||² against the
round-start global model (passed as ``prox_ref`` to the step).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.utils.tree import tree_zeros_like


def prox_term(params, ref) -> torch.Tensor:
    """Σ over leaves of ||p − ref||², leaves in the JAX tree order
    (sorted keys)."""
    total = 0
    for k in sorted(params):
        total = total + torch.sum(torch.square(params[k] - ref[k]))
    return total


def _grads_of(loss_fn, params, batch, prox_mu, prox_ref):
    """(total loss, metrics, grads) of one batch: the loss with the prox
    term, the metrics detached."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, metrics = loss_fn(leaves, batch)
    total = loss
    if prox_mu and prox_ref is not None:
        total = loss + 0.5 * prox_mu * prox_term(leaves, prox_ref)
    grads = torch.autograd.grad(total, list(leaves.values()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, dict(zip(leaves, grads))


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    prox_mu: float = 0.0, clip_norm: Optional[float] = None,
                    accum_steps: int = 1, donate: bool = True):
    """loss_fn(params, batch) -> (scalar, metrics).

    ``accum_steps > 1`` enables gradient accumulation (microbatching):
    the batch's leading dim is split into ``accum_steps`` microbatches
    whose gradients are summed in order from zeros and then divided by
    ``accum_steps`` before the one optimizer update; the total loss is
    averaged alike and the metrics are the last microbatch's.
    ``clip_norm`` clips the gradients to that global norm and adds
    ``metrics["grad_norm"]`` (the norm before clipping).  ``donate`` is
    accepted for the JAX package's signature and has no effect: torch
    has no buffer donation, and the step never writes into ``params``.
    """

    def step(params, opt_state, batch, prox_ref=None):
        if accum_steps > 1:
            gsum = tree_zeros_like(params)
            loss_sum = 0.0
            for i in range(accum_steps):
                mb = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, metrics, g = _grads_of(loss_fn, params, mb, prox_mu,
                                             prox_ref)
                gsum = {k: gsum[k] + g[k] for k in gsum}
                loss_sum = loss_sum + loss
            grads = {k: g / accum_steps for k, g in gsum.items()}
            loss = loss_sum / accum_steps
        else:
            loss, metrics, grads = _grads_of(loss_fn, params, batch, prox_mu,
                                             prox_ref)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics["grad_norm"] = gnorm
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            new_params = {k: params[k] + updates[k] for k in params}
        metrics["total_loss"] = loss
        return new_params, opt_state, metrics

    return step


def make_eval_step(loss_fn: Callable):
    """step(params, batch) -> the loss function's metrics, without
    gradients."""
    def step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch)
        return metrics
    return step


def make_grad_fn(loss_fn: Callable):
    """Full-batch gradient (used by the ε-coreset audit):
    grad_fn(params, batch) -> (grads, metrics)."""
    def grad_fn(params, batch):
        _, metrics, grads = _grads_of(loss_fn, params, batch, 0.0, None)
        return grads, metrics
    return grad_fn
