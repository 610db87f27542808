"""k-medoids solvers for the FedCore coreset problem (Eq. 5).

Two implementations of the same (BUILD + PAM-objective SWAP) algorithm,
as in the JAX package:

* ``kmedoids_numpy`` — host-side float64, loops until convergence: the
  exactness oracle.
* ``_kmedoids_batched`` — the on-device solver over a (C, M, M) distance
  stack with masked lanes; ``kmedoids_masked`` / ``kmedoids_jax`` are its
  C = 1 (and all-valid) views.  BUILD's ``lax.scan`` is a Python loop
  whose argmin stays on the device; the SWAP ``lax.while_loop`` is a loop
  with one host sync per sweep (the any-lane-still-improving test).  The
  BUILD add-cost and the Δ-sweep reductions go through
  ``repro_torch.kernels.ops`` (CUDA kernels on the card).
* ``kmedoids_batched_from_feats`` — the same BUILD + SWAP (one shared
  ``_build_swap``) straight from a (C, M, F) feature stack: the fleet
  engine's selection at M ≥ 256, where the distance-free kernels compute
  the distances from the features into a workspace of at most
  ``kernels.ops.FROM_FEATS_WORKSPACE_BYTES`` a call.

Swap Δ (FasterPAM, Schubert & Rousseeuw 2021): with d1/d2 the nearest /
second-nearest medoid distance of each point and n(i) its nearest slot,

    Δ(j, l) = A_j + B_{j,l}
    A_j     = Σ_i ( min(D[i,j], d1_i) − d1_i )
    B_{j,l} = Σ_{i: n(i)=l} ( clip(D[i,j], d1_i, d2_i) − d1_i )

Ties break to the first index everywhere (``torch.argmin`` documents
first-index ties, as ``jnp.argmin`` has them).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import (kmedoids_build_cost,
                                     kmedoids_build_cost_from_feats,
                                     kmedoids_delta_sweep,
                                     kmedoids_delta_sweep_from_feats,
                                     pairwise_l2, resolve_use_kernel)
from repro_torch.obs import get_recorder

BIG = 1e30


class KMedoidsResult(NamedTuple):
    medoids: torch.Tensor     # (k,) int32 indices into the dataset
    assignment: torch.Tensor  # (m,) int32 index into [0, k)
    weights: torch.Tensor     # (k,) int32 cluster sizes (the paper's δ)
    objective: torch.Tensor   # scalar Σ_i min_k D[i, medoid_k]


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------

def _build_numpy(D: np.ndarray, k: int) -> np.ndarray:
    medoids = np.empty(k, np.int64)
    medoids[0] = np.argmin(D.sum(axis=0))
    d_near = D[:, medoids[0]].copy()
    for i in range(1, k):
        # cost of adding candidate j: sum(min(d_near, D[:, j]))
        cost = np.minimum(d_near[:, None], D).sum(axis=0)
        cost[medoids[:i]] = BIG
        medoids[i] = np.argmin(cost)
        d_near = np.minimum(d_near, D[:, medoids[i]])
    return medoids


def kmedoids_numpy(D: np.ndarray, k: int, max_sweeps: int = 100
                   ) -> KMedoidsResult:
    """Float64 BUILD + SWAP on the host; returns CPU tensors."""
    D = np.asarray(D, np.float64)
    m = D.shape[0]
    k = min(k, m)
    medoids = _build_numpy(D, k)

    for _ in range(max_sweeps):
        dm = D[:, medoids]                      # (m, k)
        order = np.argsort(dm, axis=1)
        n_idx = order[:, 0]                     # nearest medoid slot
        d1 = dm[np.arange(m), n_idx]
        d2 = dm[np.arange(m), order[:, 1]] if k > 1 else np.full(m, BIG)

        A = np.minimum(D - d1[:, None], 0.0).sum(axis=0)          # (m,)
        contrib = (np.minimum(D, d2[:, None]) - d1[:, None]
                   - np.minimum(D - d1[:, None], 0.0))            # (m_i, m_j)
        B = np.zeros((m, k))
        np.add.at(B.T, n_idx, contrib)  # B[j, l] = Σ_{i: n(i)=l} contrib[i, j]
        delta = A[:, None] + B                                    # (m_j, k)
        delta[medoids, :] = BIG  # cannot swap a medoid in
        j, l = np.unravel_index(np.argmin(delta), delta.shape)
        if delta[j, l] >= -1e-12:
            break
        medoids[l] = j

    dm = D[:, medoids]
    assignment = np.argmin(dm, axis=1)
    weights = np.bincount(assignment, minlength=k)
    objective = dm[np.arange(m), assignment].sum()
    return KMedoidsResult(torch.as_tensor(medoids, dtype=torch.int32),
                          torch.as_tensor(assignment, dtype=torch.int32),
                          torch.as_tensor(weights, dtype=torch.int32),
                          torch.tensor(objective, dtype=torch.float32))


def medoid_objective_f64(feats: np.ndarray, medoids) -> float:
    """Σ_i min_k ‖x_i − x_{medoid_k}‖ in float64 — the objective
    ``kmedoids_numpy`` minimises, for scoring tied medoid sets."""
    x = np.asarray(feats, np.float64)
    xm = x[np.asarray(medoids, np.int64)]
    d2 = ((x * x).sum(1)[:, None] + (xm * xm).sum(1)[None, :]
          - 2.0 * (x @ xm.T))
    return float(np.sqrt(np.maximum(d2, 0.0)).min(axis=1).sum())


# ---------------------------------------------------------------------------
# on-device solver (natively batched; masked lanes)
# ---------------------------------------------------------------------------

def _take_col(D: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """D (C, M, M), idx (C,) -> (C, M) = D[c, :, idx[c]]."""
    c, m = D.shape[0], D.shape[1]
    return torch.gather(D, 2, idx[:, None, None].expand(c, m, 1))[..., 0]


def _legacy_delta_sweep(D, d1, d2, vf, onehot):
    """The pre-fusion Δ-sweep chain of the JAX package's
    ``legacy_sweep``: the minimum, the one-hot and an einsum as three
    passes over the (C, M, M) stack, in plain PyTorch (the selection
    A/B's baseline).  Its d1 / d2 / nearest slot are the fused sweep's,
    the values the reference's ``lax.top_k(-dm, 2)`` gives (ties to the
    first index)."""
    shift = torch.clamp_max(D - d1[..., None], 0.0) * vf[..., None]
    A = torch.sum(shift, dim=1)
    contrib = ((torch.minimum(D, d2[..., None]) - d1[..., None])
               * vf[..., None] - shift)
    return A, torch.einsum("cij,cil->cjl", contrib, onehot)


def _build_swap(valid: torch.Tensor, k: int, max_sweeps: int, add_cost,
                col_dists, medoid_dists, delta_sweep) -> KMedoidsResult:
    """BUILD + SWAP over a cohort, whatever holds the distances.

    ``add_cost(d_near)`` is the (C, M) BUILD add-cost, ``col_dists(idx)``
    the (C, M) distances to column idx[c], ``medoid_dists(medoids)`` the
    (C, M, k) distances to the medoid set and ``delta_sweep(d1, d2,
    onehot)`` the FasterPAM (A, B) pair; the D-input and the distance-free
    solvers differ only in these four."""
    c, m = valid.shape
    dev = valid.device
    invalid = ~valid.bool()
    iota_m = torch.arange(m, device=dev)
    iota_k = torch.arange(k, device=dev)

    obs = get_recorder()

    # ---- BUILD (greedy adds; sums masked by vf, invalid candidates BIG) ---
    # d_near = +BIG for the first pick reduces the add-cost to the column sum
    with obs.span("kmedoids_build", n_clients=c, m=m, k=k):
        cost0 = torch.where(invalid, BIG,
                            add_cost(torch.full((c, m), BIG, device=dev)))
        first = torch.argmin(cost0, dim=1)                         # (C,)
        d_near = col_dists(first)
        chosen = iota_m[None] == first[:, None]
        picks = [first]
        for _ in range(k - 1):
            cost = torch.where(chosen | invalid, BIG, add_cost(d_near))
            nxt = torch.argmin(cost, dim=1)
            d_near = torch.minimum(d_near, col_dists(nxt))
            chosen = chosen | (iota_m[None] == nxt[:, None])
            picks.append(nxt)
        medoids = torch.stack(picks, dim=1)                        # (C, k)

    # ---- SWAP sweeps (FasterPAM Δ table; all reductions masked by vf) -----
    def sweep(medoids):
        dm = medoid_dists(medoids)                                # (C, M, k)
        d1 = torch.amin(dm, dim=-1)
        n_idx = torch.argmin(dm, dim=-1)
        n_onehot = iota_k[None, None] == n_idx[..., None]
        # second-nearest = min with the nearest slot masked out
        # (k = 1 masks everything, giving the conventional d2 = BIG)
        d2 = torch.amin(torch.where(n_onehot, BIG, dm), dim=-1)
        A, B = delta_sweep(d1, d2, n_onehot.float())
        delta = A[..., None] + B                                  # (C, M, k)
        is_medoid = (iota_m[None, :, None] == medoids[:, None, :]).any(-1)
        delta = torch.where((is_medoid | invalid)[..., None], BIG, delta)
        flat = torch.argmin(delta.reshape(c, m * k), dim=1)
        best = torch.gather(delta.reshape(c, m * k), 1, flat[:, None])[:, 0]
        j = flat // k
        l = flat % k
        swapped = torch.where(iota_k[None] == l[:, None], j[:, None],
                              medoids)
        medoids = torch.where((best < -1e-6)[:, None], swapped, medoids)
        return medoids, best

    # one host round trip a sweep: the any-lane-still-improving test
    with obs.span("kmedoids_swap", n_clients=c, m=m, k=k) as sp:
        best = torch.full((c,), -float("inf"), device=dev)
        it = 0
        while it < max_sweeps and bool(torch.any(best < -1e-6)):
            medoids, best = sweep(medoids)
            it += 1
        sp.attrs["sweeps"] = it

    dm = medoid_dists(medoids)
    assignment = torch.where(valid.bool(), torch.argmin(dm, dim=-1), -1)
    weights = (assignment[..., None] == iota_k).sum(dim=1)
    objective = torch.sum(torch.amin(dm, dim=-1) * valid.float(), dim=1)
    return KMedoidsResult(medoids.to(torch.int32),
                          assignment.to(torch.int32),
                          weights.to(torch.int32), objective)


def _kmedoids_batched(D: torch.Tensor, valid: torch.Tensor, k: int,
                      max_sweeps: int, use_kernel: bool,
                      legacy_sweep: bool) -> KMedoidsResult:
    D = D.float().contiguous()
    c, m = D.shape[0], D.shape[1]
    vf = valid.float().contiguous()          # (C, M) 1.0 on real samples

    def medoid_dists(medoids):
        return torch.gather(D, 2, medoids[:, None, :].expand(c, m, k))

    if legacy_sweep:
        def delta_sweep(d1, d2, onehot):
            return _legacy_delta_sweep(D, d1, d2, vf, onehot)
    else:
        def delta_sweep(d1, d2, onehot):
            return kmedoids_delta_sweep(D, d1, d2, vf, onehot,
                                        use_kernel=use_kernel)

    return _build_swap(
        valid, k, max_sweeps,
        add_cost=lambda d_near: kmedoids_build_cost(
            D, d_near, vf, use_kernel=use_kernel),
        col_dists=lambda idx: _take_col(D, idx),
        medoid_dists=medoid_dists, delta_sweep=delta_sweep)


def kmedoids_batched(D: torch.Tensor, valid: torch.Tensor, k: int,
                     max_sweeps: int = 50,
                     use_kernel: Optional[bool] = None,
                     legacy_sweep: bool = False) -> KMedoidsResult:
    """One masked k-medoids solve per client over a cohort stack.

    D: (C, M, M) distance stack; valid: (C, M) sample masks; ``k`` shared
    across the cohort.  Padded entries are never selected, contribute
    nothing to any objective or Δ sum, and get assignment −1 / weight 0.
    Callers must guarantee ``k <= valid[c].sum()`` per lane.  Converged
    lanes are fixed points of the sweep, so each lane's result equals its
    standalone solve.  ``use_kernel`` is the tri-state kernel switch
    (``repro_torch.kernels.ops.resolve_use_kernel``); ``legacy_sweep``
    runs the pre-fusion sweep chain (the minimum / one-hot / einsum
    passes) in plain PyTorch, the selection A/B's baseline."""
    return _kmedoids_batched(D, valid, min(int(k), D.shape[-1]),
                             int(max_sweeps),
                             resolve_use_kernel(use_kernel, D.device),
                             bool(legacy_sweep))


# ---------------------------------------------------------------------------
# distance-free solver: same BUILD + SWAP from the features
# ---------------------------------------------------------------------------

def _col_dists(xf: torch.Tensor, sq: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """(C, M) distances of every row to row idx[c], rebuilt from the
    features, with an exact zero at the self index."""
    c, m, f = xf.shape
    xc = torch.gather(xf, 1, idx[:, None, None].expand(c, 1, f))  # (C, 1, F)
    sqc = torch.gather(sq, 1, idx[:, None])                       # (C, 1)
    d2 = (sq + sqc) - 2.0 * torch.sum(xf * xc, dim=-1)
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    iota_m = torch.arange(m, device=xf.device)
    return torch.where(iota_m[None] == idx[:, None], 0.0, d)


def _medoid_dists(xf: torch.Tensor, sq: torch.Tensor,
                  medoids: torch.Tensor) -> torch.Tensor:
    """(C, M, k) distances to the medoid set, one rebuilt column per slot.

    Row sums over F, not a batched matrix product: a row sum gives each
    client the same bits whatever the cohort's size, where a product's
    library kernel may split its sum by the batch's shape — and the loop
    engine (one client) must pick the medoids the batched one picks."""
    return torch.stack([_col_dists(xf, sq, medoids[:, s])
                        for s in range(medoids.shape[1])], dim=-1)


def _kmedoids_batched_from_feats(feats: torch.Tensor, valid: torch.Tensor,
                                 k: int, max_sweeps: int,
                                 use_kernel: bool) -> KMedoidsResult:
    xf = feats.float().contiguous()
    sq = torch.sum(xf * xf, dim=-1)          # (C, M) squared norms, once
    vf = valid.float().contiguous()
    return _build_swap(
        valid, k, max_sweeps,
        add_cost=lambda d_near: kmedoids_build_cost_from_feats(
            xf, d_near, vf, use_kernel=use_kernel),
        col_dists=lambda idx: _col_dists(xf, sq, idx),
        medoid_dists=lambda medoids: _medoid_dists(xf, sq, medoids),
        delta_sweep=lambda d1, d2, onehot: kmedoids_delta_sweep_from_feats(
            xf, d1, d2, vf, onehot, use_kernel=use_kernel))


def kmedoids_batched_from_feats(feats: torch.Tensor, valid: torch.Tensor,
                                k: int, max_sweeps: int = 50,
                                use_kernel: Optional[bool] = None
                                ) -> KMedoidsResult:
    """Distance-free twin of :func:`kmedoids_batched`.

    feats: (C, M, F) per-client feature stack; valid: (C, M) masks.  Same
    BUILD + SWAP and masking contract, but on the kernel path the (C, M, M)
    distance stack takes at most the workspace cap
    (``kernels.ops.FROM_FEATS_WORKSPACE_BYTES``, in client chunks or row
    bands beyond it): the BUILD add-cost and the Δ-sweep compute the
    distances from the features in each call, and the only other
    distance tensors are (C, M) columns and the (C, M, k) medoid slab.
    Padded lanes must carry zero feature rows; the reductions mask those
    candidates to +BIG so they can never tie-win a medoid election."""
    return _kmedoids_batched_from_feats(
        feats, valid, min(int(k), feats.shape[1]), int(max_sweeps),
        resolve_use_kernel(use_kernel, feats.device))


def kmedoids_masked(D: torch.Tensor, valid: torch.Tensor, k: int,
                    max_sweeps: int = 50,
                    use_kernel: Optional[bool] = None) -> KMedoidsResult:
    """Masked solve of a single padded instance — the C = 1 view of
    ``kmedoids_batched``."""
    res = kmedoids_batched(D[None], valid[None], k, max_sweeps, use_kernel)
    return KMedoidsResult(res.medoids[0], res.assignment[0], res.weights[0],
                          res.objective[0])


def kmedoids_jax(D: torch.Tensor, k: int, max_sweeps: int = 50,
                 use_kernel: Optional[bool] = None) -> KMedoidsResult:
    """On-device BUILD+SWAP on an unpadded instance — the all-valid view
    of ``kmedoids_masked`` (named after the JAX package's solver it
    ports)."""
    valid = torch.ones((D.shape[0],), dtype=torch.bool, device=D.device)
    return kmedoids_masked(D, valid, k, max_sweeps=max_sweeps,
                           use_kernel=use_kernel)


def pairwise_sq_dists(x: torch.Tensor,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """(m, d) -> (m, m) squared Euclidean distances with an exact-zero
    self-distance diagonal (the pairwise wrapper owns that fix-up)."""
    return pairwise_l2(x.contiguous(), squared=True, zero_diag=True,
                       use_kernel=use_kernel)
