"""Server-side aggregation for the synchronous FL runtime.

``SyncWeightedMean`` is the round-synchronous FedAvg rule
w_{r+1} = Σᵢ αᵢ wᵢ / Σᵢ αᵢ with αᵢ = mⁱ (or 1), over flat parameter
dicts.  The async aggregators (FedAsync, FedBuff, delayed gradients) and
the robust combine rules of the JAX package are not ported yet.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.utils.tree import Params, tree_weighted_mean


def weighted_mean_params(trees: Sequence[Params], n_samples: Sequence[int],
                         weight_by_samples: bool = True,
                         fallback: Params = None) -> Params:
    """FedAvg aggregation: mean of ``trees`` weighted by mⁱ (or uniform).

    With no contributing mass — an empty ``trees`` or all-zero weights —
    the round no-ops and returns ``fallback`` (the round-start params);
    without a fallback the degenerate case raises."""
    if weight_by_samples:
        weights = [float(n) for n in n_samples]
    else:
        weights = [1.0] * len(trees)
    if not trees or sum(weights) <= 0.0:
        if fallback is not None:
            return fallback
        raise ValueError("weighted_mean_params: no updates / all-zero "
                         "weights and no fallback params")
    return tree_weighted_mean(trees, weights)


class SyncWeightedMean:
    """Weighted mean over one round's cohort of updates."""
    name = "sync_mean"

    def __init__(self, weight_by_samples: bool = True):
        self.weight_by_samples = weight_by_samples

    def aggregate(self, trees: Sequence[Params], n_samples: Sequence[int],
                  fallback: Params = None) -> Params:
        return weighted_mean_params(trees, n_samples, self.weight_by_samples,
                                    fallback=fallback)
