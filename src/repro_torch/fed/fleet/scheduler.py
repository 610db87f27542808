"""Adaptive participation scheduling (FLANP-style) for fleet-scale FL.

A numpy-only copy of the JAX package's ``fed/fleet/scheduler.py``, kept
in the port so it imports nothing of that package; the tests hold its
``select`` and ``budget`` sequences equal to the reference's.

Straggler-Resilient Federated Learning (Reisizadeh et al., 2020) observes
that early rounds are statistically cheap — a small cohort of fast
clients reaches the coarse-accuracy regime sooner — and that
participation should grow geometrically as the model's statistical
accuracy begins to demand more data.  The policy:

  * **doubling cohorts**: start from the ``min_cohort`` fastest clients
    and grow the cohort by ``growth_factor`` whenever the train loss
    plateaus (no relative improvement ≥ ``plateau_tol`` for
    ``plateau_patience`` consecutive rounds);
  * **slowdown-aware selection**: client speed is ranked by an EWMA of
    *observed* capability (work units / realized duration), not the
    nominal cⁱ; an ``explore_frac`` of each cohort is sampled uniformly
    from the remainder so observations never go fully stale;
  * **observed-capability coreset budgets**: ``budget(cid, τ, E)`` feeds
    the observed EWMA into the paper's bⁱ = ⌊(cⁱτ − mⁱ)/(E−1)⌋.

Runtimes drive it through the duck-typed select / observe /
record_round / budget protocol.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.fed.cost import resolve_cost
from repro_torch.fed.simulator import ClientSpec
from repro_torch.obs import get_recorder


@dataclasses.dataclass(frozen=True)
class ParticipationConfig:
    min_cohort: int = 8           # FLANP n₀
    max_cohort: Optional[int] = None   # cap (None = all clients)
    growth_factor: float = 2.0    # cohort multiplier on plateau
    plateau_tol: float = 0.02     # relative loss improvement that counts
    plateau_patience: int = 1     # plateaued rounds before growing
    ewma: float = 0.5             # observed-capability smoothing weight
    explore_frac: float = 0.125   # cohort fraction sampled outside the
    # fastest set, keeping slow-client estimates fresh
    seed: int = 0


class AdaptiveParticipation:
    """FLANP doubling cohorts + slowdown-aware sampling + adaptive budgets."""

    def __init__(self, specs: Sequence[ClientSpec],
                 cfg: ParticipationConfig | None = None, cost=None):
        self.cfg = cfg or ParticipationConfig()
        # per-sample step cost (repro_torch.fed.cost; None = legacy unit): the
        # EWMA observes work in *cost units*, so ``budget`` divides τ by
        # what a sample-visit actually costs on this workload
        self.cost = resolve_cost(cost)
        self.specs = list(specs)
        self.n = len(self.specs)
        self.sizes = np.array([s.m for s in self.specs], np.int64)
        # prior for observed capability: the nominal spec value
        self.observed = np.array([s.c for s in self.specs], np.float64)
        self._n_obs = np.zeros(self.n, np.int64)
        self.cohort = min(self.cfg.min_cohort, self.n)
        self._best_loss = np.inf
        self._stall = 0
        self._round = 0
        self._rng = np.random.default_rng(self.cfg.seed)
        self.growth_log: List[int] = []   # rounds at which the cohort grew

    # -- participation ----------------------------------------------------

    def cohort_size(self) -> int:
        cap = self.cfg.max_cohort or self.n
        return int(min(self.cohort, cap, self.n))

    def _speed_order(self) -> np.ndarray:
        # stable sort: capability ties break by cid, keeping selection
        # deterministic for a given observation history
        return np.argsort(-self.observed, kind="stable")

    def select(self) -> np.ndarray:
        """This round's cohort: fastest-by-observation, plus exploration."""
        k = self.cohort_size()
        order = self._speed_order()
        n_explore = min(int(round(k * self.cfg.explore_frac)), self.n - k)
        fast = order[:k - n_explore]
        rest = order[k - n_explore:]
        if n_explore > 0 and len(rest):
            explore = self._rng.choice(rest, size=n_explore, replace=False)
            return np.sort(np.concatenate([fast, explore]))
        return np.sort(fast)

    def eligible_mask(self) -> np.ndarray:
        """Dispatch weights for the async runtime: 1.0 for the current
        fastest cohort, ``explore_frac`` for everyone else (0 disables
        exploration and the mask is strictly binary).  The soft tail is
        what keeps out-of-cohort capability estimates fresh under
        asynchrony — the same role ``explore_frac`` plays in
        ``select()``."""
        mask = np.full(self.n, self.cfg.explore_frac, np.float64)
        mask[self._speed_order()[: self.cohort_size()]] = 1.0
        return mask

    # -- feedback ---------------------------------------------------------

    def observe(self, cid: int, work_units: float, duration: float) -> None:
        """Fold one realized (work, duration) pair into the capability EWMA."""
        if duration <= 0 or work_units <= 0:
            return
        c_hat = work_units / duration
        a = self.cfg.ewma
        self.observed[cid] = (1.0 - a) * self.observed[cid] + a * c_hat
        self._n_obs[cid] += 1
        get_recorder().metrics.histogram(
            "scheduler.observed_capability").observe(c_hat)

    def record_round(self, train_loss: float) -> None:
        """FLANP growth test: grow the cohort when loss stops improving."""
        self._round += 1
        obs = get_recorder()
        if obs.enabled:     # the EWMA state, visible as gauges per round
            obs.metrics.gauge("scheduler.cohort_size").set(
                self.cohort_size())
            obs.metrics.gauge("scheduler.mean_observed_capability").set(
                float(self.observed.mean()))
            obs.metrics.gauge("scheduler.n_growths").set(
                len(self.growth_log))
        if not np.isfinite(train_loss):
            return
        if train_loss < self._best_loss * (1.0 - self.cfg.plateau_tol):
            self._best_loss = train_loss
            self._stall = 0
            return
        self._stall += 1
        if self._stall >= self.cfg.plateau_patience:
            if self.cohort_size() < (self.cfg.max_cohort or self.n):
                self.cohort = int(np.ceil(
                    self.cohort * self.cfg.growth_factor))
                self.growth_log.append(self._round)
            self._stall = 0

    # -- budgets ----------------------------------------------------------

    def budget(self, cid: int, deadline: float, epochs: int) -> int:
        """Coreset budget from *observed* capability (paper §4.2 with
        cⁱ ← EWMA of realized capability, in cost units/second)."""
        s = self.specs[cid]
        c_obs = float(self.observed[cid])
        if not self.cost.needs_coreset(s.m, c_obs, deadline, epochs):
            return s.m
        return self.cost.budget(s.m, c_obs, deadline, epochs)

    def summary(self) -> dict:
        return {
            "cohort": self.cohort_size(),
            "n_growths": len(self.growth_log),
            "mean_observed_capability": float(self.observed.mean()),
            "n_observed_clients": int((self._n_obs > 0).sum()),
        }

    # -- checkpoint/resume ------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able snapshot of all mutable state — observed-capability
        EWMA, plateau tracker, and the exploration RNG's bit-generator
        state — so a resumed run replays selection byte-identically."""
        return {
            "observed": self.observed.tolist(),
            "n_obs": self._n_obs.tolist(),
            "cohort": int(self.cohort),
            "best_loss": float(self._best_loss),
            "stall": int(self._stall),
            "round": int(self._round),
            "growth_log": list(self.growth_log),
            "rng_state": self._rng.bit_generator.state,
        }

    def load_state_dict(self, state: dict) -> None:
        self.observed = np.asarray(state["observed"], np.float64)
        self._n_obs = np.asarray(state["n_obs"], np.int64)
        self.cohort = int(state["cohort"])
        self._best_loss = float(state["best_loss"])
        self._stall = int(state["stall"])
        self._round = int(state["round"])
        self.growth_log = [int(r) for r in state["growth_log"]]
        self._rng.bit_generator.state = state["rng_state"]
