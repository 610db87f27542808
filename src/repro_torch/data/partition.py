"""Client partitioning helpers."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def power_law_sizes(n_clients: int, mean: float, std: float,
                    rng: np.random.Generator, min_size: int = 8) -> np.ndarray:
    """Lognormal client sizes matched to a target mean/std (paper Table 1)."""
    mu = np.log(mean**2 / np.sqrt(std**2 + mean**2))
    sigma = np.sqrt(np.log(1 + std**2 / mean**2))
    sizes = rng.lognormal(mu, sigma, n_clients)
    return np.maximum(sizes.astype(int), min_size)


def train_test_split_clients(clients: List[Dict[str, np.ndarray]],
                             test_frac: float = 0.1,
                             rng: np.random.Generator | None = None
                             ) -> Tuple[list, dict]:
    """Hold out `test_frac` of every client's data into one global test set."""
    rng = rng or np.random.default_rng(0)
    train, test_parts = [], []
    for data in clients:
        m = len(next(iter(data.values())))
        n_test = max(1, int(m * test_frac))
        perm = rng.permutation(m)
        te, tr = perm[:n_test], perm[n_test:]
        train.append({k: v[tr] for k, v in data.items()})
        test_parts.append({k: v[te] for k, v in data.items()})
    test = {k: np.concatenate([p[k] for p in test_parts])
            for k in test_parts[0]}
    return train, test
