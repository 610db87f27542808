"""Frozen copy of ``make_client_specs``'s capability draw
(``repro_torch.fed.simulator.sample_capabilities``): cⁱ ~ N(1, 0.25)
samples a second, floored at 0.05 (paper §6.1)."""
from __future__ import annotations

import numpy as np


def sample_capabilities(n_clients: int, rng: np.random.Generator,
                        mean: float = 1.0, var: float = 0.25,
                        floor: float = 0.05) -> np.ndarray:
    c = rng.normal(mean, np.sqrt(var), n_clients)
    return np.maximum(c, floor)
