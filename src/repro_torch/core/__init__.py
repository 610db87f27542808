"""FedCore's primary contribution: distributed coreset selection.

Coreset problem (Eq.2) -> k-medoids reformulation (Eq.5) -> gradient-proxy
features (§4.3).
"""
from repro_torch.core.coreset import (  # noqa: F401
    Coreset,
    FedCoreConfig,
    build_coreset,
    build_coreset_batched,
    coreset_batch,
    coreset_budget,
    needs_coreset,
)
from repro_torch.core.gradients import grad_features  # noqa: F401
from repro_torch.core.kmedoids import (  # noqa: F401
    KMedoidsResult,
    kmedoids_batched,
    kmedoids_batched_from_feats,
    kmedoids_jax,
    kmedoids_numpy,
    pairwise_sq_dists,
)
