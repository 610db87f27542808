"""Pluggable server-side aggregators for the sync and async FL runtimes.

Three families operate on whole client parameter dicts:

  * ``SyncWeightedMean`` — the round-synchronous FedAvg rule
    w_{r+1} = Σᵢ αᵢ wᵢ / Σᵢ αᵢ with αᵢ = mⁱ (or 1), shared by
    ``run_federated`` and usable as a semi-sync buffered aggregator;
  * ``FedBuff`` — buffered asynchronous aggregation (Nguyen et al.,
    2022): updates accumulate in a size-K buffer; when full, the server
    mixes the staleness-discounted weighted mean of the buffer into the
    global model with server learning-rate η;
  * ``FedAsync`` — fully asynchronous staleness-polynomial mixing (Xie
    et al., 2019): every arriving update is applied at once as
    w ← (1 − α_t) w + α_t wᵢ with α_t = α·(1 + staleness)^{−a};
    ``DelayedGradient`` applies the client's staleness-discounted delta
    from its dispatch snapshot instead.

Aggregators see one ``ClientUpdate`` at a time through ``apply`` and
return new global params (the model version advances) or ``None`` (the
update was buffered).  Staleness counts server model versions between
an update's dispatch and its arrival.  Every rule builds new tensors and
changes none it is given: the async runtime keeps each dispatch's global
params as that update's ``base_params``.

A fourth family defends against the fault axes of
``repro_torch.fed.fleet.faults``: the **robust combine rules**
(coordinate-wise trimmed mean and median, Krum / multi-Krum selection,
norm clipping) over a *stacked* update set, a dict whose leaves carry a
leading client axis, as the fleet engines produce.  ``robust_combine`` is
the entry point of every runtime; ``RobustAggregate`` wraps it as a
buffered streaming aggregator for the async runtime.  The order
statistics are unweighted over clients (sample counts are
attacker-controlled metadata); ``norm_clip`` keeps the weights but bounds
each client's delta norm first.  Each rule repeats the JAX package's
arithmetic: its median is the midpoint of the two middle values, and
Krum flattens the leaves in the JAX package's leaf order and layout
(``layouts``, the model's ``reference_layouts``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils.tree import (Params, reference_leaves, tree_add,
                                    tree_scale, tree_sub, tree_weighted_mean)


@dataclasses.dataclass(frozen=True)
class ClientUpdate:
    """One client's contribution as seen by an aggregator."""
    params: Params
    n_samples: int
    staleness: int = 0            # server versions elapsed since dispatch
    base_params: Params = None    # global params the client trained from


def polynomial_staleness(staleness: int, exponent: float) -> float:
    """s(t) = (1 + t)^{−a} — the FedAsync polynomial discount."""
    return float((1.0 + staleness) ** -exponent)


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


class Aggregator:
    """Base: consume one update, maybe emit new global params."""
    name = "base"

    def apply(self, global_params: Params, update: ClientUpdate
              ) -> Optional[Params]:
        raise NotImplementedError

    def reset(self) -> None:
        """Drop buffered state; called by the runtime at the start of a
        run so a reused aggregator cannot leak updates across runs."""

    def flush(self, global_params: Params) -> Optional[Params]:
        """Merge a partially filled buffer at the end of a run: new
        global params, or ``None`` when nothing is buffered (always, for
        the unbuffered rules)."""
        return None


class _Buffered(Aggregator):
    """An aggregator that merges ``_merge(buffer, global)`` once it holds
    ``_capacity()`` updates, and on ``flush`` whatever it holds."""

    def __init__(self):
        self._buffer: List[ClientUpdate] = []

    def _capacity(self) -> int:
        raise NotImplementedError

    def _merge(self, buf: List[ClientUpdate], global_params: Params
               ) -> Params:
        raise NotImplementedError

    def apply(self, global_params, update):
        capacity = self._capacity()
        self._buffer.append(update)
        if len(self._buffer) < capacity:
            return None
        buf, self._buffer = self._buffer, []
        return self._merge(buf, global_params)

    def flush(self, global_params):
        if not self._buffer:
            return None
        buf, self._buffer = self._buffer, []
        return self._merge(buf, global_params)

    def reset(self):
        self._buffer = []


class SyncWeightedMean(_Buffered):
    """Weighted mean over a fixed cohort of ``round_size`` updates.

    With ``round_size=None`` it is a helper of the synchronous server
    (call ``aggregate``); with a round size it is a semi-synchronous
    barrier inside the async runtime."""
    name = "sync_mean"

    def __init__(self, weight_by_samples: bool = True,
                 round_size: Optional[int] = None):
        super().__init__()
        self.weight_by_samples = weight_by_samples
        self.round_size = round_size

    def aggregate(self, trees: Sequence[Params], n_samples: Sequence[int],
                  fallback: Params = None) -> Params:
        return weighted_mean_params(trees, n_samples, self.weight_by_samples,
                                    fallback=fallback)

    def _capacity(self):
        if self.round_size is None:
            raise ValueError("SyncWeightedMean needs round_size to be used "
                             "as a streaming aggregator")
        return self.round_size

    def _merge(self, buf, global_params):
        return self.aggregate([u.params for u in buf],
                              [u.n_samples for u in buf],
                              fallback=global_params)


class FedAsync(Aggregator):
    """Immediate staleness-polynomial mixing: one update, one version."""
    name = "fedasync"

    def __init__(self, mixing: float = 0.6, staleness_exponent: float = 0.5):
        if not 0.0 < mixing <= 1.0:
            raise ValueError(f"mixing must be in (0, 1], got {mixing}")
        self.mixing = mixing
        self.staleness_exponent = staleness_exponent

    def alpha(self, staleness: int) -> float:
        return self.mixing * polynomial_staleness(staleness,
                                                  self.staleness_exponent)

    def apply(self, global_params, update):
        a = self.alpha(update.staleness)
        return tree_weighted_mean([global_params, update.params],
                                  [1.0 - a, a])


class DelayedGradient(Aggregator):
    """Staleness-discounted delayed *deltas*: the progress the client made
    from its dispatch snapshot, w ← w + η·(1 + t)^{−a}·(wᵢ − w_dispatch),
    rather than a pull toward a stale client's absolute params."""
    name = "delayed_grad"

    def __init__(self, server_lr: float = 1.0,
                 staleness_exponent: float = 0.5):
        self.server_lr = server_lr
        self.staleness_exponent = staleness_exponent

    def apply(self, global_params, update):
        if update.base_params is None:
            raise ValueError("DelayedGradient needs ClientUpdate.base_params "
                             "(the dispatch-time global params)")
        scale = self.server_lr * polynomial_staleness(
            update.staleness, self.staleness_exponent)
        delta = tree_sub(update.params, update.base_params)
        return tree_add(global_params, tree_scale(delta, scale))


class FedBuff(_Buffered):
    """Buffered-K aggregation with per-update staleness discounting.

    Each buffered update carries weight (1+tᵢ)^{−a}, times mⁱ when
    ``weight_by_samples`` is set (off by default: the async runtime
    already dispatches clients ∝ mⁱ); with ``buffer_size`` updates
    buffered the server applies w ← (1 − η) w + η · weighted_mean(buffer).
    The runtimes ``flush`` a partial buffer at the end of a run."""
    name = "fedbuff"

    def __init__(self, buffer_size: int = 10, staleness_exponent: float = 0.5,
                 server_lr: float = 1.0, weight_by_samples: bool = False):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        if not 0.0 < server_lr <= 1.0:
            raise ValueError(f"server_lr must be in (0, 1], got {server_lr}")
        super().__init__()
        self.buffer_size = buffer_size
        self.staleness_exponent = staleness_exponent
        self.server_lr = server_lr
        self.weight_by_samples = weight_by_samples

    def _capacity(self):
        return self.buffer_size

    def _merge(self, buf, global_params):
        weights = []
        for u in buf:
            w = float(u.n_samples) if self.weight_by_samples else 1.0
            weights.append(w * polynomial_staleness(u.staleness,
                                                    self.staleness_exponent))
        if sum(weights) <= 0.0:
            return global_params
        mean = tree_weighted_mean([u.params for u in buf], weights)
        if self.server_lr >= 1.0:
            return mean
        return tree_weighted_mean([global_params, mean],
                                  [1.0 - self.server_lr, self.server_lr])


# ---------------------------------------------------------------------------
# robust combine rules (Byzantine-resilient aggregation) over a stacked
# update set: every leaf has a leading client axis C
# ---------------------------------------------------------------------------

ROBUST_METHODS = ("trimmed_mean", "median", "krum", "multi_krum", "norm_clip")


def stack_params(trees: Sequence[Params]) -> Params:
    """Stack per-client dicts into one dict of (C, ...) leaves."""
    if not trees:
        raise ValueError("stack_params needs at least one tree")
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _flatten_stacked(stacked: Params, layouts=None) -> torch.Tensor:
    """(C, D) float32 view of a stacked dict, its leaves concatenated in
    the JAX package's leaf order and layout."""
    return torch.cat([x.reshape(x.shape[0], -1).float()
                      for x in reference_leaves(stacked, layouts, lead=1)],
                     dim=1)


def _midpoint_median(x: torch.Tensor) -> torch.Tensor:
    """Median over axis 0 as ``jnp.median`` takes it: (low + high) · 0.5
    of the sorted middle pair (the one middle value twice for odd C)."""
    c = x.shape[0]
    s = torch.sort(x, dim=0).values
    return (s[(c - 1) // 2] + s[c // 2]) * 0.5


def trimmed_mean_stacked(stacked: Params, trim_frac: float = 0.2) -> Params:
    """Coordinate-wise β-trimmed mean: sort each coordinate over the
    client axis, drop the ⌊βC⌋ smallest and largest values, average the
    rest.  Tolerates up to ⌊βC⌋ arbitrary clients per coordinate."""
    c = next(iter(stacked.values())).shape[0]
    t = min(int(trim_frac * c), (c - 1) // 2)

    def red(x):
        if t == 0:
            return torch.mean(x, dim=0)
        return torch.mean(torch.sort(x, dim=0).values[t:c - t], dim=0)

    return {k: red(x) for k, x in stacked.items()}


def median_stacked(stacked: Params) -> Params:
    """Coordinate-wise median over the client axis (the β → 1/2 limit of
    the trimmed mean)."""
    return {k: _midpoint_median(x) for k, x in stacked.items()}


def krum_select(stacked: Params, n_byzantine: Optional[int] = None,
                multi: int = 1, layouts=None) -> np.ndarray:
    """Krum / multi-Krum selection (Blanchard et al., 2017).

    Scores each client by the sum of its C − f − 2 smallest squared
    distances to the other updates (float32, cast to float64) and returns
    the ``multi`` lowest-scoring client indices, ties broken by index.
    ``n_byzantine`` defaults to ⌈C/4⌉."""
    v = _flatten_stacked(stacked, layouts)
    c = v.shape[0]
    f = int(n_byzantine) if n_byzantine is not None else max(1, c // 4)
    sq = torch.sum(v * v, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (v @ v.T)
    d2 = torch.clamp_min(d2, 0.0) + torch.diag(
        torch.full((c,), float("inf"), device=v.device))
    k_near = max(1, min(c - f - 2, c - 1))
    scores = torch.sum(torch.sort(d2, dim=1).values[:, :k_near], dim=1)
    order = np.argsort(scores.cpu().numpy().astype(np.float64),
                       kind="stable")
    return order[:max(1, min(int(multi), c))]


def krum_stacked(stacked: Params, n_byzantine: Optional[int] = None,
                 multi: int = 1, layouts=None) -> Params:
    """Krum (``multi=1``: the single best-supported update) or multi-Krum
    (uniform mean of the ``multi`` selected updates)."""
    sel = krum_select(stacked, n_byzantine=n_byzantine, multi=multi,
                      layouts=layouts)
    if len(sel) == 1:
        return {k: x[int(sel[0])] for k, x in stacked.items()}
    first = next(iter(stacked.values()))
    idx = torch.as_tensor(np.sort(sel), device=first.device)
    return {k: torch.mean(x[idx], dim=0) for k, x in stacked.items()}


def norm_clip_stacked(stacked: Params, base: Params,
                      weights: Optional[Sequence[float]] = None,
                      clip: Optional[float] = None, layouts=None) -> Params:
    """Norm-clipped weighted mean: each client's delta from ``base`` is
    scaled down to at most ``clip`` (default: the median delta norm, so
    the bound adapts to the honest majority), then the clipped deltas are
    weighted-averaged back onto ``base``."""
    v = _flatten_stacked(stacked, layouts)
    vb = _flatten_stacked({k: x[None] for k, x in base.items()}, layouts)[0]
    norms = torch.linalg.vector_norm(v - vb[None, :], dim=1)
    bound = (_midpoint_median(norms) if clip is None
             else torch.tensor(clip, dtype=torch.float32, device=v.device))
    scale = torch.clamp_max(bound / torch.clamp_min(norms, 1e-12), 1.0)
    c = v.shape[0]
    w = (torch.ones(c, dtype=torch.float32, device=v.device)
         if weights is None
         else torch.as_tensor(np.asarray(weights, np.float32),
                              device=v.device))
    total = torch.sum(w)
    if not bool(total > 0):
        return base
    coef = w * scale / torch.clamp_min(total, 1e-12)
    return {k: b + torch.tensordot(coef, (stacked[k] - b[None]).float(),
                                   dims=1).to(b.dtype)
            for k, b in base.items()}


def robust_combine(stacked: Params, method: str,
                   weights: Optional[Sequence[float]] = None,
                   base: Params = None, trim_frac: float = 0.2,
                   n_byzantine: Optional[int] = None,
                   layouts=None) -> Params:
    """Combine a (C, ...) stacked update set with a named rule.

    ``method`` is one of ``ROBUST_METHODS`` or ``"weighted_mean"`` (the
    non-robust baseline).  ``base``, the round-start global params, is
    the fallback for an empty stack and the reference point of
    ``norm_clip``.  Weights only affect ``weighted_mean`` and
    ``norm_clip``.  ``layouts`` (the model's ``reference_layouts``) puts
    Krum's and ``norm_clip``'s flattened vectors in the JAX package's
    coordinate order."""
    c = next(iter(stacked.values())).shape[0] if stacked else 0
    if c == 0:
        if base is not None:
            return base
        raise ValueError("robust_combine: empty update stack and no base")
    if method == "weighted_mean":
        w = [1.0] * c if weights is None else [float(x) for x in weights]
        if sum(w) <= 0.0:
            if base is not None:
                return base
            raise ValueError("robust_combine: all-zero weights and no base")
        first = next(iter(stacked.values()))
        wt = (torch.as_tensor(np.asarray(w, np.float32), device=first.device)
              / float(np.float32(sum(w))))
        return {k: torch.tensordot(wt, x.float(), dims=1)
                for k, x in stacked.items()}
    if method == "trimmed_mean":
        return trimmed_mean_stacked(stacked, trim_frac=trim_frac)
    if method == "median":
        return median_stacked(stacked)
    if method == "krum":
        return krum_stacked(stacked, n_byzantine=n_byzantine, multi=1,
                            layouts=layouts)
    if method == "multi_krum":
        f = int(n_byzantine) if n_byzantine is not None else max(1, c // 4)
        return krum_stacked(stacked, n_byzantine=f, multi=max(1, c - f - 2),
                            layouts=layouts)
    if method == "norm_clip":
        if base is None:
            raise ValueError("norm_clip needs base (round-start) params")
        return norm_clip_stacked(stacked, base, weights=weights,
                                 layouts=layouts)
    raise ValueError(f"unknown combine method {method!r} (expected "
                     f"weighted_mean or one of {ROBUST_METHODS})")


class RobustAggregate(_Buffered):
    """Buffered robust aggregation for the streaming (async) server.

    Buffers ``round_size`` updates, then replaces the global model with
    ``robust_combine`` over the buffered stack: the semi-synchronous
    barrier of ``SyncWeightedMean`` with a Byzantine-resilient combine
    rule inside.  ``layouts`` as in ``robust_combine``."""

    def __init__(self, method: str = "trimmed_mean", round_size: int = 8,
                 weight_by_samples: bool = True, trim_frac: float = 0.2,
                 n_byzantine: Optional[int] = None, layouts=None):
        if method not in ROBUST_METHODS:
            raise ValueError(f"unknown robust method {method!r} "
                             f"(expected one of {ROBUST_METHODS})")
        if round_size < 1:
            raise ValueError(f"round_size must be >= 1, got {round_size}")
        super().__init__()
        self.name = method
        self.method = method
        self.round_size = round_size
        self.weight_by_samples = weight_by_samples
        self.trim_frac = trim_frac
        self.n_byzantine = n_byzantine
        self.layouts = layouts

    def _capacity(self):
        return self.round_size

    def _merge(self, buf, global_params):
        weights = ([float(u.n_samples) for u in buf]
                   if self.weight_by_samples else None)
        return robust_combine(stack_params([u.params for u in buf]),
                              self.method, weights=weights,
                              base=global_params, trim_frac=self.trim_frac,
                              n_byzantine=self.n_byzantine,
                              layouts=self.layouts)


AGGREGATORS = {
    "sync_mean": SyncWeightedMean,
    "fedasync": FedAsync,
    "fedbuff": FedBuff,
    "delayed_grad": DelayedGradient,
    **{m: functools.partial(RobustAggregate, m) for m in ROBUST_METHODS},
}
