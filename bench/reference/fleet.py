"""A FedCore round over a fleet of clients (FedCore Alg. 1 with the
fleet's batching rules), worked out again from the inputs alone.

Per round, every client of the cohort trains from the round-start
params θ with mini-batch SGD of batch B, E epochs, each epoch visiting
its M padded slots in its own seeded permutation (M the next power of
two of batches; padded slots repeat the last sample with loss weight 0).
τ is the (100 − s)-th percentile of the full-round times E·mⁱ/cⁱ
(times 1 + a slack, which lets s = 0 mean that every client meets τ); a
client with E·mⁱ > cⁱτ is a straggler with budget bⁱ = ⌊(cⁱτ − mⁱ)/(E −
1)⌋ in [1, mⁱ], rounded down to a power of four (k).  A straggler takes
the last-layer-gradient features of its samples at θ, selects k medoids
(BUILD + SWAP), runs one full epoch, then E − 1 full-batch steps on the
medoids weighted by their cluster sizes.  The server's new params are
the mean of the clients' params weighted by mⁱ.

Clients that share (M, k) are computed together (``torch.func.vmap``
over the client axis of one client's step, each client's batch taken
inside it) and each straggler's features one client at a time; the
grouping changes no client's arithmetic.
Where ``follow`` gives a straggler's medoids (the program's, to judge
them), its coreset epochs train on those, weighted by their cluster
sizes here; its own solve then only scores them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from bench.reference import kmedoids, smallcnn

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    epochs: int
    batch: int
    lr: float
    max_sweeps: int
    straggler_pct: float


@dataclasses.dataclass
class RoundOut:
    params: Params
    losses: Dict[int, float]              # cid -> last local loss
    medoids: Dict[int, np.ndarray]        # cid -> medoid indices trained on
    obj_gap: Dict[int, float]             # cid -> followed medoids' excess


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _floor_pow4(n: int) -> int:
    return 1 << (((max(int(n), 1).bit_length() - 1) // 2) * 2)


def budgets(sizes: np.ndarray, caps: np.ndarray, spec: FleetSpec
            ) -> np.ndarray:
    """Each client's budget: mⁱ for full-set training, else bⁱ."""
    e = spec.epochs
    times = e * sizes / caps
    tau = float(np.percentile(times, 100.0 - spec.straggler_pct))
    needs = e * sizes > caps * tau
    b = np.floor((caps * tau - sizes) / (e - 1)).astype(np.int64)
    return np.where(needs, np.clip(b, 1, sizes), sizes)


def groups(sizes: np.ndarray, budget: np.ndarray, spec: FleetSpec
           ) -> List[Tuple[int, int, List[int]]]:
    """[(M, k, cids)] in (M, k) order; k = 0 is full-set training."""
    by: Dict[Tuple[int, int], List[int]] = {}
    for cid, (m, b) in enumerate(zip(sizes, budget)):
        m_pad = _next_pow2(-(-int(m) // spec.batch)) * spec.batch
        k = 0 if b >= m else _floor_pow4(b)
        by.setdefault((m_pad, k), []).append(cid)
    return [(m, k, cids) for (m, k), cids in sorted(by.items())]


def permutations(seed: int, round_seed: int, cids: Sequence[int],
                 m_pad: int, epochs: int) -> np.ndarray:
    """(C, E, M) per-client epoch orders from (seed, round, cid)."""
    base = np.tile(np.arange(m_pad), (epochs, 1))
    return np.stack([np.random.default_rng(
        np.random.SeedSequence((seed, round_seed, int(c)))
    ).permuted(base, axis=1) for c in cids])


def _stack(clients, cids, m_pad):
    def pad(v):
        return (v if len(v) == m_pad else
                np.concatenate([v, np.repeat(v[-1:], m_pad - len(v), 0)]))
    x = np.stack([pad(clients[c]["x"]) for c in cids])
    y = np.stack([pad(clients[c]["y"]) for c in cids])
    ms = np.array([len(clients[c]["y"]) for c in cids])
    return x, y, np.arange(m_pad)[None] < ms[:, None]


def _client_step(p: Params, x, y, w, lr):
    """One SGD step of one client on (x, y) weighted by w."""
    g, loss = grad_and_value(smallcnn.weighted_loss)(p, x, y, w)
    return {k: p[k] - lr * g[k] for k in p}, loss


def _client_batch_step(p: Params, x, y, w, ix, lr):
    """One client's mini-batch step on the samples ``ix`` of its data."""
    return _client_step(p, x[ix], y[ix], w[ix], lr)


# every client of a group in one call, as the fleet batches them
_BATCH_STEP = vmap(_client_batch_step, in_dims=(0, 0, 0, 0, 0, None))
_FULL_STEP = vmap(_client_step, in_dims=(0, 0, 0, 0, None))


def _sgd(p: Params, x, y, w, idx, lr):
    """Steps over idx (C, T, B); returns (params, last losses)."""
    loss = None
    for t in range(idx.shape[1]):
        p, loss = _BATCH_STEP(p, x, y, w, idx[:, t], lr)
    return p, loss


def fleet_round(params: Params, clients, sizes: np.ndarray,
                caps: np.ndarray, spec: FleetSpec, seed: int,
                round_seed: int, device,
                follow: Optional[Dict[int, np.ndarray]] = None,
                solve_dtype=torch.float64) -> RoundOut:
    dev = torch.device(device)
    budget = budgets(sizes, caps, spec)
    acc = None
    total = 0.0
    out = RoundOut({}, {}, {}, {})
    b, e = spec.batch, spec.epochs
    for m_pad, k, cids in groups(sizes, budget, spec):
        c = len(cids)
        xs, ys, valid = _stack(clients, cids, m_pad)
        x = torch.as_tensor(xs, device=dev)
        y = torch.as_tensor(ys, device=dev)
        vt = torch.as_tensor(valid, device=dev)
        w = vt.float()
        perms = permutations(seed, round_seed, cids, m_pad, e)
        idx = torch.as_tensor(perms.reshape(c, e * (m_pad // b), b),
                              device=dev)
        p0 = {n: v.expand((c,) + v.shape) for n, v in params.items()}
        if k == 0:
            p, loss = _sgd(p0, x, y, w, idx, spec.lr)
        else:
            with torch.no_grad():
                f = torch.stack([smallcnn.grad_features(params, x[i], y[i])
                                 for i in range(c)]) * w[..., None]
                D = kmedoids.distances(f.to(solve_dtype))
                own = kmedoids.solve(D, vt, k, spec.max_sweeps)
                med = own.medoids
                if follow is not None:
                    med = torch.as_tensor(np.stack([np.asarray(
                        follow[cid], np.int64) for cid in cids]), device=dev)
                    med = med.clamp(0, m_pad - 1)
                    obj = kmedoids.objective(D, vt, med)
                    gap = ((obj - own.objective)
                           / torch.clamp_min(own.objective, 1e-12))
                    for cid, g in zip(cids, gap.tolist()):
                        out.obj_gap[cid] = g
                cw = kmedoids.cluster_sizes(D, vt, med).float()
            p, _ = _sgd(p0, x, y, w, idx[:, : m_pad // b], spec.lr)
            rows = torch.arange(c, device=dev)[:, None]
            cx, cy = x[rows, med], y[rows, med]
            for _ in range(max(e - 1, 1)):
                p, loss = _FULL_STEP(p, cx, cy, cw, spec.lr)
            for cid, s in zip(cids, med.cpu().numpy()):
                out.medoids[cid] = s
        # the group's sum weighted by mⁱ in float32, the groups' sums
        # added in order, as the configuration's precision has it
        ms = torch.as_tensor(sizes[cids].astype(np.float32), device=dev)
        part = {n: torch.tensordot(ms, p[n], dims=([0], [0])) for n in p}
        acc = part if acc is None else {n: acc[n] + part[n] for n in acc}
        total += float(sizes[cids].astype(np.float64).sum())
        for cid, l in zip(cids, loss.tolist()):
            out.losses[cid] = l
    out.params = {n: v / total for n, v in acc.items()}
    return out
