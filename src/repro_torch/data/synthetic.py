"""Synthetic(α, β) federated dataset — exact re-implementation of the
generator from FedProx (Li et al., 2020), used by the paper's Synthetic
benchmark (§6.1): α controls cross-client model heterogeneity, β controls
within-client feature heterogeneity.

Per client i:
    u_i ~ N(0, α);     W_i ~ N(u_i, 1) ∈ R^{60×10},  b_i ~ N(u_i, 1) ∈ R^10
    B_i ~ N(0, β);     v_i ~ N(B_i, 1) ∈ R^60
    x_ij ~ N(v_i, Σ),  Σ = diag(j^{-1.2})
    y_ij = argmax(softmax(W_i x_ij + b_i))
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.data.partition import power_law_sizes


def synthetic_dataset(alpha: float, beta: float, n_clients: int = 30,
                      n_features: int = 60, n_classes: int = 10,
                      mean_samples: float = 670.0, std_samples: float = 1148.0,
                      seed: int = 0) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    sizes = power_law_sizes(n_clients, mean_samples, std_samples, rng,
                            min_size=20)
    diag = np.array([(j + 1) ** (-1.2) for j in range(n_features)])
    clients = []
    for i in range(n_clients):
        u = rng.normal(0.0, np.sqrt(alpha))
        Bm = rng.normal(0.0, np.sqrt(beta))
        W = rng.normal(u, 1.0, (n_features, n_classes))
        b = rng.normal(u, 1.0, n_classes)
        v = rng.normal(Bm, 1.0, n_features)
        m = int(sizes[i])
        x = rng.normal(loc=v, scale=np.sqrt(diag), size=(m, n_features))
        logits = x @ W + b
        y = np.argmax(logits, axis=1)
        clients.append({"x": x.astype(np.float32), "y": y.astype(np.int32)})
    return clients
