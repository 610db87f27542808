"""The paper's SmallCNN (FedCore §6.1, MNIST): two 5x5 "same"
convolutions of 16 and 32 channels, each followed by ReLU and a 2x2 max
pool, and a dense head from the flattened 7x7x32 = 1568 features to 10
classes; the weighted cross-entropy of the FL clients and FedCore's
last-layer-gradient features (§4.3).

Weights are a flat dict: ``conv1`` (16, 1, 5, 5), ``b1``, ``conv2`` (32,
16, 5, 5), ``b2``, ``w_out`` (1568, 10), ``b_out``; convolution kernels
stored out-in-height-width and the features flattened height, width,
channel, the layout the harness draws them in."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def features(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, 28, 28) -> (B, 1568)."""
    h = x[:, None]
    h = F.max_pool2d(torch.relu(F.conv2d(h, p["conv1"], padding=2)
                                + p["b1"][None, :, None, None]), 2, 2)
    h = F.max_pool2d(torch.relu(F.conv2d(h, p["conv2"], padding=2)
                                + p["b2"][None, :, None, None]), 2, 2)
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    return features(p, x) @ p["w_out"] + p["b_out"]


def weighted_loss(p: Params, x: torch.Tensor, y: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Σ w·nll / max(Σ w, 1e-9): padded samples carry weight 0 and a
    coreset sample its cluster size."""
    nll = -torch.gather(F.log_softmax(logits(p, x), -1), -1,
                        y.long()[:, None])[:, 0]
    return torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1e-9)


def grad_features(p: Params, x: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    """§4.3's proxy: ∂L/∂z = (softmax(z) − onehot(y)) W_outᵀ, (B, 1568)."""
    z = logits(p, x)
    dz = torch.softmax(z, -1) - F.one_hot(y.long(), z.shape[-1]).float()
    return dz @ p["w_out"].T


def forward_flops(image: int = 28, channels=(16, 32), k: int = 5,
                  classes: int = 10) -> float:
    """Multiply-adds of one sample's forward pass, times 2."""
    c1, c2 = channels
    s1, s2 = image, image // 2
    macs = (s1 * s1 * c1 * k * k * 1 + s2 * s2 * c2 * k * k * c1
            + (image // 4) ** 2 * c2 * classes)
    return 2.0 * macs
