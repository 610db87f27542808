"""Pseudo-MNIST: an offline, distribution-matched surrogate for the paper's
MNIST benchmark (Table 1: 1000 clients, ~69 samples/client mean, 106 std,
2 distinct digits per client, power-law sizes).

Images are generated from 10 smooth random class prototypes (low-frequency
Gaussian fields) plus per-sample elastic-ish jitter and pixel noise — a task
a small CNN learns to >95% but that is not linearly separable, preserving
the benchmark's role.  Documented as a surrogate in EXPERIMENTS.md.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.data.partition import power_law_sizes


def _smooth_field(rng: np.random.Generator, size: int, cutoff: int = 6
                  ) -> np.ndarray:
    """Low-frequency random image in [-1, 1]."""
    spec = np.zeros((size, size), np.complex128)
    spec[:cutoff, :cutoff] = (rng.normal(size=(cutoff, cutoff))
                              + 1j * rng.normal(size=(cutoff, cutoff)))
    img = np.real(np.fft.ifft2(spec))
    img = img / (np.abs(img).max() + 1e-9)
    return img


def make_prototypes(n_classes: int = 10, size: int = 28, seed: int = 1234
                    ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([_smooth_field(rng, size) for _ in range(n_classes)])


def mnist_like_dataset(n_clients: int = 1000, mean_samples: float = 69.0,
                       std_samples: float = 106.0, digits_per_client: int = 2,
                       n_classes: int = 10, size: int = 28,
                       noise: float = 0.35, seed: int = 0
                       ) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    protos = make_prototypes(n_classes, size)
    sizes = power_law_sizes(n_clients, mean_samples, std_samples, rng,
                            min_size=10)
    clients = []
    for i in range(n_clients):
        digits = rng.choice(n_classes, size=digits_per_client, replace=False)
        m = int(sizes[i])
        y = rng.choice(digits, size=m)
        shift = rng.integers(-2, 3, size=(m, 2))
        xs = np.empty((m, size, size), np.float32)
        for j in range(m):
            img = np.roll(protos[y[j]], tuple(shift[j]), axis=(0, 1))
            xs[j] = img + noise * rng.normal(size=(size, size))
        clients.append({"x": xs.astype(np.float32), "y": y.astype(np.int32)})
    return clients
