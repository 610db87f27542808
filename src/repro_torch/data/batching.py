"""Mini-batch iteration over client datasets (numpy-side, feeding jit steps)."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def epoch_batches(data: Dict[str, np.ndarray], batch_size: int,
                  rng: np.random.Generator, drop_remainder: bool = False
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled mini-batches for one epoch.

    Per-example ``weights`` (coreset δ) ride along with their samples.
    """
    m = len(next(iter(data.values())))
    perm = rng.permutation(m)
    end = (m // batch_size) * batch_size if drop_remainder else m
    for lo in range(0, end, batch_size):
        idx = perm[lo:lo + batch_size]
        yield {k: v[idx] for k, v in data.items()}


def batch_iterator(data: Dict[str, np.ndarray], batch_size: int, steps: int,
                   rng: np.random.Generator) -> Iterator[Dict[str, np.ndarray]]:
    """Endless shuffled batches, stopping after `steps` batches."""
    done = 0
    while done < steps:
        for batch in epoch_batches(data, batch_size, rng):
            yield batch
            done += 1
            if done >= steps:
                return
