"""k-medoids by BUILD and SWAP (Kaufman & Rousseeuw's PAM, with
FasterPAM's swap deltas of Schubert & Rousseeuw 2021), batched over
clients whose rows are masked: the coreset problem of FedCore Eq. 5.

With d1 / d2 a point's nearest / second-nearest medoid distance and n(i)
its nearest slot, the change of the objective when medoid slot l is
swapped for point j is Δ(j, l) = A_j + B_{j,l}:

    A_j     = Σ_i min(D[i, j] − d1_i, 0)
    B_{j,l} = Σ_{i: n(i)=l} (min(D[i, j], d2_i) − d1_i − min(D[i, j] − d1_i, 0))

BUILD adds, one at a time, the point that lowers Σ_i min(d_near_i,
D[i, j]) most; SWAP makes the best swap while it lowers the objective by
more than ``tol``, at most ``max_sweeps`` times.  Ties go to the lowest
index.  Invalid (padded) rows are never chosen and count for nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e30


class Solve(NamedTuple):
    medoids: torch.Tensor      # (C, k) int64
    weights: torch.Tensor      # (C, k) cluster sizes
    objective: torch.Tensor    # (C,)
    sweeps: int


def distances(x: torch.Tensor) -> torch.Tensor:
    """(C, M, F) -> (C, M, M) Euclidean distances, zero on the diagonal,
    in x's dtype."""
    sq = torch.sum(x * x, dim=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * (x @ x.transpose(1, 2))
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    eye = torch.eye(x.shape[1], dtype=torch.bool, device=x.device)
    return torch.where(eye, torch.zeros((), dtype=d.dtype,
                                        device=d.device), d)


def objective(D: torch.Tensor, valid: torch.Tensor,
              medoids: torch.Tensor) -> torch.Tensor:
    """(C,) Σ over valid rows of the distance to the nearest medoid."""
    c, m, _ = D.shape
    dm = torch.gather(D, 2, medoids[:, None, :].expand(c, m,
                                                        medoids.shape[1]))
    return torch.sum(torch.amin(dm, -1) * valid.to(D.dtype), dim=1)


def cluster_sizes(D: torch.Tensor, valid: torch.Tensor,
                  medoids: torch.Tensor) -> torch.Tensor:
    """(C, k) the valid rows nearest to each medoid slot."""
    c, m, _ = D.shape
    k = medoids.shape[1]
    dm = torch.gather(D, 2, medoids[:, None, :].expand(c, m, k))
    near = torch.argmin(dm, -1)
    onehot = torch.nn.functional.one_hot(near, k) * valid[..., None]
    return onehot.sum(1)


def solve(D: torch.Tensor, valid: torch.Tensor, k: int, max_sweeps: int,
          tol: float = 1e-6) -> Solve:
    c, m, _ = D.shape
    dev, dt = D.device, D.dtype
    vf = valid.to(dt)
    invalid = ~valid.bool()
    rows = torch.arange(c, device=dev)
    big = torch.tensor(BIG, dtype=dt, device=dev)
    # BUILD
    cost = torch.where(invalid, big, torch.sum(D * vf[:, :, None], dim=1))
    first = torch.argmin(cost, 1)
    d_near = D[rows, :, first]
    chosen = torch.zeros((c, m), dtype=torch.bool, device=dev)
    chosen[rows, first] = True
    picks = [first]
    for _ in range(k - 1):
        add = torch.sum(torch.minimum(D, d_near[:, :, None])
                        * vf[:, :, None], dim=1)
        nxt = torch.argmin(torch.where(chosen | invalid, big, add), 1)
        d_near = torch.minimum(d_near, D[rows, :, nxt])
        chosen[rows, nxt] = True
        picks.append(nxt)
    med = torch.stack(picks, 1)
    # SWAP
    slots = torch.arange(k, device=dev)
    sweeps = 0
    active = torch.ones(c, dtype=torch.bool, device=dev)
    while sweeps < max_sweeps and bool(active.any()):
        dm = torch.gather(D, 2, med[:, None, :].expand(c, m, k))
        d1, near = torch.min(dm, -1)
        onehot = near[..., None] == slots
        d2 = torch.amin(torch.where(onehot, big, dm), -1)
        shift = torch.clamp_max(D - d1[:, :, None], 0.0) * vf[:, :, None]
        A = shift.sum(1)                                       # (C, M)
        contrib = ((torch.minimum(D, d2[:, :, None]) - d1[:, :, None])
                   * vf[:, :, None] - shift)                   # (C, i, j)
        B = torch.einsum("cij,cil->cjl", contrib, onehot.to(dt))
        delta = A[..., None] + B                               # (C, M, k)
        is_med = torch.zeros((c, m), dtype=torch.bool, device=dev)
        is_med[rows[:, None], med] = True
        delta = torch.where((is_med | invalid)[..., None], big, delta)
        best, flat = torch.min(delta.reshape(c, m * k), 1)
        j, l = flat // k, flat % k
        active = best < -tol
        swapped = torch.where(slots[None] == l[:, None], j[:, None], med)
        med = torch.where(active[:, None], swapped, med)
        sweeps += 1
    return Solve(med, cluster_sizes(D, valid, med), objective(D, valid, med),
                 sweeps)
