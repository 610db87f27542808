"""Gradient-feature extraction for FedCore (§4.3).

``grad_features(model, params, data)`` returns the (m, F) matrix the
k-medoids clustering runs on, on the device of ``params``:

  * ``feature_space == "input"``           — convex models: the raw inputs
    (d̃ⱼₖ = ‖xⱼ − xₖ‖; static across rounds).
  * ``feature_space == "last_layer_grad"`` — DNNs: ∂L/∂z at the last layer
    input, in closed form from the softmax residual pulled back through
    the output matrix — one forward pass, no per-sample backprop.

``true_per_sample_grads`` and ``project_features`` are not ported yet.
"""
from __future__ import annotations

import torch


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
