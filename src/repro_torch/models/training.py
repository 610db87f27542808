"""Train-step factory for the FL models.

``make_train_step(loss_fn, optimizer, prox_mu)`` returns
``step(params, opt_state, batch, prox_ref=None) -> (params, opt_state,
metrics)`` over flat parameter dicts.  Gradients come from autograd
through plain PyTorch layers, as the JAX package takes ``jax.grad``
through XLA.

FedProx support: ``prox_mu > 0`` adds (mu/2)||w - w_ref||² against the
round-start global model (passed as ``prox_ref`` to the step).
Gradient accumulation and clipping are not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim.optimizers import Optimizer


def prox_term(params, ref) -> torch.Tensor:
    """Σ over leaves of ||p − ref||², leaves in the JAX tree order
    (sorted keys)."""
    total = 0
    for k in sorted(params):
        total = total + torch.sum(torch.square(params[k] - ref[k]))
    return total


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    prox_mu: float = 0.0):
    """loss_fn(params, batch) -> (scalar, metrics)."""

    def step(params, opt_state, batch, prox_ref=None):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, metrics = loss_fn(leaves, batch)
        total = loss
        if prox_mu and prox_ref is not None:
            total = loss + 0.5 * prox_mu * prox_term(leaves, prox_ref)
        grads = torch.autograd.grad(total, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            new_params = {k: params[k] + updates[k] for k in params}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        return new_params, opt_state, metrics

    return step
