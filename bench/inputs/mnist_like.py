"""Frozen copy of the port's pseudo-MNIST generator
(``repro_torch.data.mnist_like``, with ``power_law_sizes`` of
``repro_torch.data.partition``): the paper's Table-1 MNIST fleet (1,000
clients, lognormal sizes of mean 69 and std 106, two digits a client).

``mnist_like_dataset`` gives the port's bytes for the same arguments
(``bench/tests/check_inputs.py``); ``draw_clients`` is its per-client
part for a given list of sizes, vectorised over a client's samples in the
same draw order.  The harness and the reference call these, never the
port's generator.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def power_law_sizes(n_clients: int, mean: float, std: float,
                    rng: np.random.Generator, min_size: int = 8
                    ) -> np.ndarray:
    mu = np.log(mean**2 / np.sqrt(std**2 + mean**2))
    sigma = np.sqrt(np.log(1 + std**2 / mean**2))
    sizes = rng.lognormal(mu, sigma, n_clients)
    return np.maximum(sizes.astype(int), min_size)


def _smooth_field(rng: np.random.Generator, size: int, cutoff: int = 6
                  ) -> np.ndarray:
    spec = np.zeros((size, size), np.complex128)
    spec[:cutoff, :cutoff] = (rng.normal(size=(cutoff, cutoff))
                              + 1j * rng.normal(size=(cutoff, cutoff)))
    img = np.real(np.fft.ifft2(spec))
    return img / (np.abs(img).max() + 1e-9)


def make_prototypes(n_classes: int = 10, size: int = 28, seed: int = 1234
                    ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([_smooth_field(rng, size) for _ in range(n_classes)])


def draw_clients(sizes: Sequence[int], rng: np.random.Generator,
                 n_classes: int = 10, digits_per_client: int = 2,
                 size: int = 28, noise: float = 0.35
                 ) -> List[Dict[str, np.ndarray]]:
    """Each client's digits, labels, shifts and noisy images, drawn from
    ``rng`` in the port's order: a client's per-sample noise draws follow
    one another, so one draw of (m, size, size) gives the same values."""
    protos = make_prototypes(n_classes, size)
    # every prototype at every shift in [-2, 2]²
    rolled = np.stack([np.stack([np.stack(
        [np.roll(p, (a, b), axis=(0, 1)) for b in range(-2, 3)])
        for a in range(-2, 3)]) for p in protos])      # (cls, 5, 5, H, W)
    clients = []
    for m in sizes:
        m = int(m)
        digits = rng.choice(n_classes, size=digits_per_client, replace=False)
        y = rng.choice(digits, size=m)
        shift = rng.integers(-2, 3, size=(m, 2))
        eps = rng.normal(size=(m, size, size))
        xs = (rolled[y, shift[:, 0] + 2, shift[:, 1] + 2]
              + noise * eps).astype(np.float32)
        clients.append({"x": xs, "y": y.astype(np.int32)})
    return clients


def mnist_like_dataset(n_clients: int = 1000, mean_samples: float = 69.0,
                       std_samples: float = 106.0, digits_per_client: int = 2,
                       n_classes: int = 10, size: int = 28,
                       noise: float = 0.35, seed: int = 0
                       ) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    sizes = power_law_sizes(n_clients, mean_samples, std_samples, rng,
                            min_size=10)
    return draw_clients(sizes, rng, n_classes, digits_per_client, size,
                        noise)
