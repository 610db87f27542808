"""FedCore coreset construction (paper §3.2, §4.2, §4.3).

The coreset problem (Eq. 2) is upper-bounded (Eq. 3-4) and solved as a
k-medoids instance (Eq. 5) over *gradient features*:

  * convex models      -> input-space features  (d̃ⱼₖ = ‖xⱼ − xₖ‖)
  * deep networks      -> last-layer gradient features
                          (d̂ⱼₖ = ‖∂Lⱼ/∂zⱼ − ∂Lₖ/∂zₖ‖, §4.3)

The budget (§4.2): the first epoch of a round runs the full set (mⁱ samples,
producing the features); the remaining E−1 epochs run the coreset, so

    bⁱ = ⌊(cⁱ·τ − mⁱ) / (E − 1)⌋.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import gradients
from repro_torch.core.kmedoids import (kmedoids_batched,
                                       kmedoids_batched_from_feats,
                                       kmedoids_jax, kmedoids_numpy,
                                       pairwise_sq_dists)
from repro_torch.kernels.ops import pairwise_l2_batched, resolve_use_kernel


class Coreset(NamedTuple):
    indices: torch.Tensor     # (k,) int32 — selected sample indices Sⁱ
    weights: torch.Tensor     # (k,) float32 — δⁱ (cluster sizes)
    objective: torch.Tensor   # scalar — the Eq.(5) k-medoids objective
    assignment: torch.Tensor  # (m,) int32 — Φⁱ mapping (by medoid slot)


def coreset_budget(m: int, capability: float, deadline: float,
                   epochs: int, cost=None) -> int:
    """bⁱ = ⌊(cⁱτ − mⁱ·κ)/(κ(E−1))⌋ clipped to [1, mⁱ] (paper §4.2);
    ``cost`` as in ``repro_torch.fed.cost.resolve_cost`` (imported
    lazily: ``repro_torch.fed`` imports this module at package init)."""
    from repro_torch.fed.cost import resolve_cost
    return resolve_cost(cost).budget(m, capability, deadline, epochs)


def needs_coreset(m: int, capability: float, deadline: float,
                  epochs: int, cost=None) -> bool:
    """Alg. 1 line 6: full-set training iff E·mⁱ·κ ≤ cⁱτ."""
    from repro_torch.fed.cost import resolve_cost
    return resolve_cost(cost).needs_coreset(m, capability, deadline, epochs)


def build_coreset(features: torch.Tensor, budget: int, *,
                  backend: str = "jax", use_kernel: Optional[bool] = None,
                  max_sweeps: int = 50,
                  projection_dim: Optional[int] = None) -> Coreset:
    """Solve Eq.(5) on the per-sample feature matrix (m, F).

    Distances are Euclidean in feature space.  ``use_kernel`` is the
    tri-state kernel switch for the pairwise distances and the fused
    k-medoids reductions (None = CUDA kernels for tensors on the card,
    plain PyTorch on the CPU).  ``backend="jax"`` is the on-device solver
    (the name is the JAX package's); ``"numpy"`` the float64 host oracle.
    ``projection_dim`` applies a JL random projection first
    (``repro_torch.core.gradients.project_features``).
    """
    m = features.shape[0]
    budget = min(budget, m)
    if projection_dim is not None:
        features = gradients.project_features(features, projection_dim)
    D2 = pairwise_sq_dists(features, use_kernel=use_kernel)
    D = torch.sqrt(torch.clamp_min(D2, 0.0))
    if backend == "numpy":
        res = kmedoids_numpy(D.cpu().numpy(), budget, max_sweeps=max_sweeps)
    elif backend == "jax":
        res = kmedoids_jax(D, budget, max_sweeps=max_sweeps,
                           use_kernel=use_kernel)
    else:
        raise ValueError(f"unknown k-medoids backend {backend!r}")
    return Coreset(indices=res.medoids, weights=res.weights.float(),
                   objective=res.objective, assignment=res.assignment)


def build_coreset_batched(features: torch.Tensor, valid: torch.Tensor,
                          budget: int, *, use_kernel: Optional[bool] = None,
                          max_sweeps: int = 50, distance_free: bool = True,
                          materialize_below: int = 256) -> Coreset:
    """One coreset per client over a padded cohort stack (fleet engine).

    features: (C, M, F) per-client gradient features, rows with
    ``valid[c, i]`` False being padding; ``budget`` is the per-client k
    shared by the group.  Returns a ``Coreset`` of stacked fields
    (indices (C, k), weights (C, k), ...); each lane solves the instance
    ``build_coreset`` would solve on that client's unpadded features.

    ``materialize_below`` is the cutover on the padded M: below it the
    (C, M, M) stack is small and recomputing distances every BUILD step
    and Δ-sweep costs more than it saves, so selection runs the batched
    pairwise kernel and the D-input solver.  At ``M >= materialize_below``
    with ``distance_free`` it streams: the distance-free solver never
    stores D.  ``materialize_below=0`` streams at any size.
    """
    c, m, _ = features.shape
    budget = min(budget, m)
    uk = resolve_use_kernel(use_kernel, features.device)
    if distance_free and m >= materialize_below:
        # padded rows must be zero features: their mutually-zero
        # distances are masked in the kernels (+BIG candidates)
        feats = features * valid.to(features.dtype)[..., None]
        res = kmedoids_batched_from_feats(feats, valid, budget,
                                          max_sweeps=max_sweeps,
                                          use_kernel=uk)
    else:
        D = pairwise_l2_batched(features.float().contiguous(), squared=False,
                                zero_diag=True, use_kernel=uk)
        res = kmedoids_batched(D, valid, budget, max_sweeps=max_sweeps,
                               use_kernel=uk)
    return Coreset(indices=res.medoids, weights=res.weights.float(),
                   objective=res.objective, assignment=res.assignment)


def coreset_epsilon(grads_full, coreset: Coreset) -> torch.Tensor:
    """Audit Assumption A.3 on *true* per-sample gradients.

    grads_full: (m, P) per-sample gradients (flattened; a tensor or a
    numpy array, as ``true_per_sample_grads`` gives), taken to the
    coreset's device.  Returns ε = (1/m)‖Σⱼ gⱼ − Σₖ δₖ g_{medoid k}‖₂.
    """
    g = torch.as_tensor(grads_full, device=coreset.indices.device)
    m = g.shape[0]
    full = torch.sum(g, dim=0)
    sel = g[coreset.indices.long()]
    approx = torch.sum(sel * coreset.weights[:, None], dim=0)
    return torch.linalg.vector_norm(full - approx) / m


def coreset_batch(data: dict, coreset: Coreset, m_full: int) -> dict:
    """Materialize the weighted coreset training set from a client dataset.

    Weights are δₖ, normalised implicitly by the weighted loss (which
    divides by Σw), matching Eq.(9)'s (1/mⁱ)Σδₖ∇Lₖ since Σₖ δₖ = mⁱ.
    The dataset stays in numpy on the host, as the batching does.
    """
    idx = coreset.indices.cpu().numpy()
    out = {k: v[idx] for k, v in data.items() if k != "weights"}
    out["weights"] = coreset.weights.cpu().numpy().astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# configuration record for the FL runtime
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FedCoreConfig:
    backend: str = "jax"         # kmedoids solver ("jax" on-device, "numpy")
    # tri-state kernel switch: None = CUDA kernels for tensors on the
    # card, plain PyTorch on the CPU; False on the card is the A/B
    use_kernel: Optional[bool] = None
    max_sweeps: int = 50
    projection_dim: Optional[int] = None  # JL projection (§Perf H3)
    # Alg. 1 drop path for clients that cannot meet τ even with the §4.4
    # minimal plan (coreset of 1, one partial epoch).  Default False:
    # train the minimal plan and mark ClientResult.deadline_violated.
    drop_infeasible: bool = False
