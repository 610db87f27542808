"""Plain PyTorch versions of the selection kernels (the correctness contract).

Each function is the mathematical definition its CUDA kernel in
``csrc/`` must reproduce, as the JAX package's ``kernels/ref.py`` defines
it, and each repeats its kernel's arithmetic: every sum runs over its
reduced index in order, one rounded product and one rounded add per
term.  A kernel and its plain version therefore agree bit for bit on the
card, and a run with ``use_kernel=False`` picks the same medoids as one
through the kernels — k-medoids turns the last bit of a distance sum into
a different, equally good coreset.  The loops make these versions slow;
they are no yardstick of speed.  ``repro_torch.kernels.ops`` takes them
for tensors on the CPU, the tests hold them against the JAX ops, and
``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

BIG = 1e30      # padded-candidate mask (``repro_torch.core.kmedoids.BIG``)


def pairwise_l2_ref(x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                    squared: bool = False) -> torch.Tensor:
    """(m, d), (n, d) -> (m, n) Euclidean distances, fp32 accumulation:
    (‖a‖² + ‖b‖²) − 2·ab, the cross term summed over d in order."""
    y = x if y is None else y
    xf = x.float()
    yf = y.float()
    cross = torch.zeros((xf.shape[0], yf.shape[0]), dtype=torch.float32,
                        device=xf.device)
    for k in range(xf.shape[1]):
        cross += xf[:, k, None] * yf[None, :, k]
    sq = (torch.sum(xf * xf, dim=-1)[:, None]
          + torch.sum(yf * yf, dim=-1)[None, :]) - 2.0 * cross
    sq = torch.clamp_min(sq, 0.0)
    return sq if squared else torch.sqrt(sq)


def pairwise_l2_batched_ref(x: torch.Tensor, *,
                            squared: bool = False) -> torch.Tensor:
    """(C, M, D) -> (C, M, M) per-client self-distance stacks: each
    client's ``pairwise_l2_ref(x[c])``, the cross term summed over d in
    order."""
    xf = x.float()
    cross = torch.zeros(xf.shape[:-1] + xf.shape[-2:-1], dtype=torch.float32,
                        device=xf.device)
    for k in range(xf.shape[-1]):
        cross += xf[..., :, k, None] * xf[..., None, :, k]
    sq = torch.sum(xf * xf, dim=-1)
    sq = torch.clamp_min((sq[..., :, None] + sq[..., None, :]) - 2.0 * cross,
                         0.0)
    return sq if squared else torch.sqrt(sq)


def kmedoids_build_cost_ref(D: torch.Tensor, d_near: torch.Tensor,
                            vf: torch.Tensor) -> torch.Tensor:
    """Greedy BUILD add-cost over a masked distance stack.

    D (..., M, M); d_near/vf (..., M).  Returns
    cost[..., j] = Σ_i min(d_near_i, D_ij)·vf_i (over i in order) — the
    cost of the point set after adding candidate j to the current medoids
    (``d_near`` is each point's distance to its nearest chosen medoid;
    +BIG for the first pick reduces it to the plain column sum).
    """
    cost = torch.zeros(D.shape[:-2] + D.shape[-1:], dtype=torch.float32,
                       device=D.device)
    for i in range(D.shape[-2]):
        cost += (torch.minimum(d_near[..., i, None], D[..., i, :])
                 * vf[..., i, None])
    return cost


def kmedoids_delta_sweep_ref(D: torch.Tensor, d1: torch.Tensor,
                             d2: torch.Tensor, vf: torch.Tensor,
                             n_onehot: torch.Tensor):
    """FasterPAM swap-sweep reductions (the Δ(j, l) = A_j + B_{j,l} split).

    D (..., M, M); d1/d2/vf (..., M); n_onehot (..., M, K) one-hot of each
    point's nearest-medoid slot.  Returns (A (..., M), B (..., M, K)),
    both summed over i in order:

        A[j]    = Σ_i (min(D_ij, d1_i) − d1_i) · vf_i
        B[j, l] = Σ_i (clip(D_ij, d1_i, d2_i) − d1_i) · vf_i · onehot[i, l]

    ``clip(D, d1, d2) − d1`` is the case-collapsed form of the textbook
    ``min(D, d2) − d1 − min(D − d1, 0)`` (bitwise equal for d1 ≤ d2).
    """
    A = torch.zeros(D.shape[:-2] + D.shape[-1:], dtype=torch.float32,
                    device=D.device)
    B = torch.zeros(D.shape[:-2] + D.shape[-1:] + n_onehot.shape[-1:],
                    dtype=torch.float32, device=D.device)
    for i in range(D.shape[-2]):
        Di = D[..., i, :]
        lo, hi, w = d1[..., i, None], d2[..., i, None], vf[..., i, None]
        A += (torch.minimum(Di, lo) - lo) * w
        contrib = (torch.clamp(Di, lo, hi) - lo) * w
        B += contrib[..., :, None] * n_onehot[..., i, None, :]
    return A, B


# ---------------------------------------------------------------------------
# distance-free versions: these DO materialize D, as the JAX package's
# oracles do; the CUDA kernels rebuild each distance tile from the
# features in the same arithmetic, so the two agree bit for bit
# ---------------------------------------------------------------------------

def _pairwise_from_feats(x: torch.Tensor) -> torch.Tensor:
    """(..., M, F) -> (..., M, M) Euclidean stack with an exact-zero
    diagonal."""
    d = pairwise_l2_batched_ref(x)
    eye = torch.eye(x.shape[-2], dtype=torch.bool, device=x.device)
    return torch.where(eye, 0.0, d)


def kmedoids_build_cost_from_feats_ref(x: torch.Tensor, d_near: torch.Tensor,
                                       vf: torch.Tensor) -> torch.Tensor:
    """BUILD add-cost straight from the features: x (..., M, F),
    d_near/vf (..., M) -> (..., M).  ``kmedoids_build_cost_ref`` on the
    rebuilt distance stack, with padded candidate columns (vf_j = 0) at
    +BIG so a zero-padded feature row can never win the greedy argmin."""
    cost = kmedoids_build_cost_ref(_pairwise_from_feats(x), d_near, vf)
    return torch.where(vf > 0.0, cost, BIG)


def kmedoids_delta_sweep_from_feats_ref(x: torch.Tensor, d1: torch.Tensor,
                                        d2: torch.Tensor, vf: torch.Tensor,
                                        n_onehot: torch.Tensor):
    """FasterPAM (A, B) straight from the features: x (..., M, F),
    d1/d2/vf (..., M), n_onehot (..., M, K).  ``kmedoids_delta_sweep_ref``
    on the rebuilt distance stack, with A = +BIG at padded candidates
    (vf_j = 0) so a zero-padded row can never win a swap."""
    A, B = kmedoids_delta_sweep_ref(_pairwise_from_feats(x), d1, d2, vf,
                                    n_onehot)
    return torch.where(vf > 0.0, A, BIG), B
