"""Gradient-feature extraction for FedCore (§4.3).

``grad_features(model, params, data)`` returns the (m, F) matrix the
k-medoids clustering runs on, on the device of ``params``:

  * ``feature_space == "input"``           — convex models: the raw inputs
    (d̃ⱼₖ = ‖xⱼ − xₖ‖; static across rounds).
  * ``feature_space == "last_layer_grad"`` — DNNs: ∂L/∂z at the last layer
    input, in closed form from the softmax residual pulled back through
    the output matrix — one forward pass, no per-sample backprop.

``true_per_sample_grads`` computes exact per-sample full-model gradients
with ``vmap`` of ``grad``: O(m) backprops, used only by tests and the ε
audit to certify the proxy (never on the training path).
``project_features`` is the Johnson-Lindenstrauss projection of the
features (§Perf H3 of the JAX package).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch.utils.tree import reference_leaves


def _num_examples(data: dict) -> int:
    return next(iter(data.values())).shape[0]


def grad_features(model, params, data: dict, batch_size: int = 512
                  ) -> torch.Tensor:
    """Per-sample gradient features for a whole (numpy) client dataset."""
    device = next(iter(params.values())).device
    space = getattr(model, "feature_space", "last_layer_grad")
    if space == "input":
        x = torch.as_tensor(data["x"], device=device)
        return x.reshape(x.shape[0], -1)
    m = _num_examples(data)
    feats = []
    with torch.no_grad():
        for lo in range(0, m, batch_size):
            batch = {k: torch.as_tensor(v[lo:lo + batch_size], device=device)
                     for k, v in data.items()}
            feats.append(model.grad_features(params, batch))
    return torch.cat(feats, dim=0)


def true_per_sample_grads(loss_fn: Callable, params, data: dict,
                          batch_size: int = 64) -> np.ndarray:
    """Exact per-sample gradients, flattened to an (m, P) float32 array.
    Test and audit only.

    ``loss_fn(params, batch) -> (loss, metrics)`` is a model's ``loss``;
    the columns follow the JAX package's: leaves in its flatten order
    (tree paths sorted) and layout (the ``reference_layouts`` of the
    model ``loss_fn`` is bound to, SmallCNN's OIHW kernels as HWIO)."""
    device = next(iter(params.values())).device
    layouts = getattr(getattr(loss_fn, "__self__", None),
                      "reference_layouts", None)

    def single(p, example):
        batch = {k: v[None] for k, v in example.items()}
        return loss_fn(p, batch)[0]

    vgrad = torch.func.vmap(torch.func.grad(single), in_dims=(None, 0))
    m = _num_examples(data)
    outs = []
    for lo in range(0, m, batch_size):
        batch = {k: torch.as_tensor(v[lo:lo + batch_size], device=device)
                 for k, v in data.items()}
        g = vgrad(params, batch)
        flat = torch.cat([x.reshape(x.shape[0], -1)
                          for x in reference_leaves(g, layouts, lead=1)],
                         dim=1)
        outs.append(flat.float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def jl_matrix(f: int, dim: int, seed: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """The (f, dim) projection matrix, N(0, 1) / sqrt(dim): drawn in fp32
    on the CPU from a generator seeded with ``seed``, so the CPU and the
    card project with the same matrix.  (The JAX package draws it from
    ``jax.random``, which torch cannot replay; the parity tests put the
    JAX matrix in its place.)"""
    gen = torch.Generator().manual_seed(seed)
    proj = torch.randn((f, dim), generator=gen, dtype=torch.float32)
    return (proj / math.sqrt(dim)).to(device=device, dtype=dtype)


def project_features(feats: torch.Tensor, dim: int, seed: int = 0
                     ) -> torch.Tensor:
    """Johnson-Lindenstrauss random projection of gradient features.

    The k-medoids distance matrix costs O(m²·F); projecting the (m, F)
    features to F' = ``dim`` with a scaled Gaussian matrix keeps pairwise
    distances within (1 ± ε) w.h.p. and cuts the distance FLOPs by F/F'.
    A no-op when ``dim >= F``."""
    f = feats.shape[1]
    if dim >= f:
        return feats
    return feats @ jl_matrix(f, dim, seed, feats.dtype, feats.device)
