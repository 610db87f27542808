"""System-heterogeneity simulator (paper §6.1 "Implementations").

Each client i gets a compute capability cⁱ ~ N(1, 0.25) (samples/sec,
clipped positive); training one sample for one epoch costs 1/cⁱ seconds, so
a full round costs E·mⁱ/cⁱ.  The per-round deadline τ is chosen so that the
slowest s% of clients cannot complete full-set training in time — those are
the stragglers.

For the asynchronous runtime the static cⁱ is additionally perturbed by a
``CapabilityTrace``: per-dispatch slowdown *episodes* (a two-state Markov
chain per client — devices go hot/contended for a few dispatches at a time)
plus i.i.d. lognormal jitter on each realized duration, so arrival
processes are realistic rather than deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.fed.cost import resolve_cost


@dataclasses.dataclass(frozen=True)
class ClientSpec:
    cid: int
    m: int          # training-set size
    c: float        # capability (cost units / second; legacy: samples/s)

    def full_round_time(self, epochs: int, cost=None) -> float:
        """E full-set epochs.  ``cost`` (a ``repro.fed.cost``
        ``WorkloadCostModel`` or per-sample scalar; None = legacy
        samples-cost-1.0) prices each sample-visit, so the same cⁱ
        yields workload-honest durations."""
        if cost is None:
            return epochs * self.m / self.c
        return resolve_cost(cost).full_round_time(self.m, self.c, epochs)


def sample_capabilities(n_clients: int, rng: np.random.Generator,
                        mean: float = 1.0, var: float = 0.25,
                        floor: float = 0.05) -> np.ndarray:
    c = rng.normal(mean, np.sqrt(var), n_clients)
    return np.maximum(c, floor)


def make_client_specs(sizes: Sequence[int], rng: np.random.Generator
                      ) -> List[ClientSpec]:
    caps = sample_capabilities(len(sizes), rng)
    return [ClientSpec(cid=i, m=int(m), c=float(c))
            for i, (m, c) in enumerate(zip(sizes, caps))]


def straggler_deadline(specs: Sequence[ClientSpec], epochs: int,
                       straggler_pct: float, cost=None) -> float:
    """τ such that the slowest `straggler_pct`% of clients exceed it."""
    times = np.array([s.full_round_time(epochs, cost) for s in specs])
    return float(np.percentile(times, 100.0 - straggler_pct))


def straggler_mask(specs: Sequence[ClientSpec], epochs: int, deadline: float,
                   cost=None) -> np.ndarray:
    return np.array([s.full_round_time(epochs, cost) > deadline
                     for s in specs])


# ---------------------------------------------------------------------------
# time-varying capability traces (async runtime)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceConfig:
    jitter_std: float = 0.15        # lognormal σ of per-dispatch duration jitter
    slowdown_prob: float = 0.05     # P(enter a slowdown episode) per dispatch
    slowdown_factor: float = 3.0    # capability divisor while in an episode
    slowdown_mean_len: float = 3.0  # mean episode length, in dispatches
    seed: int = 0


class CapabilityTrace:
    """Deterministic per-(client, dispatch) capability perturbations.

    Episode state follows a two-state Markov chain over each client's
    dispatch sequence; jitter is i.i.d. lognormal.  Both are drawn from a
    per-client stream keyed by ``(seed, cid)`` and extended lazily in
    dispatch order, so the trace is a pure function of
    ``(seed, cid, dispatch_index)`` regardless of how the global event
    loop interleaves clients — a requirement for replayable event logs.
    """

    def __init__(self, cfg: TraceConfig | None = None):
        self.cfg = cfg or TraceConfig()
        self._entries: Dict[int, List[Tuple[bool, float]]] = {}
        self._rngs: Dict[int, np.random.Generator] = {}

    def _entry(self, cid: int, dispatch_index: int) -> Tuple[bool, float]:
        ent = self._entries.setdefault(cid, [])
        rng = self._rngs.get(cid)
        if rng is None:
            rng = np.random.default_rng(
                np.random.SeedSequence((self.cfg.seed, cid)))
            self._rngs[cid] = rng
        stay = 1.0 - 1.0 / max(self.cfg.slowdown_mean_len, 1.0)
        while len(ent) <= dispatch_index:
            in_episode = ent[-1][0] if ent else False
            p = stay if in_episode else self.cfg.slowdown_prob
            slowed = bool(rng.random() < p)
            # mean-1 multiplicative noise: E[lognormal(-σ²/2, σ)] = 1, so
            # jitter doesn't systematically inflate durations vs sync
            sig = self.cfg.jitter_std
            jitter = (float(rng.lognormal(-0.5 * sig * sig, sig))
                      if sig > 0 else 1.0)
            ent.append((slowed, jitter))
        return ent[dispatch_index]

    def capability(self, spec: ClientSpec, dispatch_index: int) -> float:
        """Effective cⁱ for this dispatch (known to the client at start,
        so deadline-aware strategies plan with it)."""
        slowed, _ = self._entry(spec.cid, dispatch_index)
        return spec.c / self.cfg.slowdown_factor if slowed else spec.c

    def jitter(self, spec: ClientSpec, dispatch_index: int) -> float:
        """Unpredictable multiplicative noise on the realized duration."""
        return self._entry(spec.cid, dispatch_index)[1]


class DispatchTraceIndexer:
    """Per-client dispatch cursors into a (possibly absent) trace.

    Every runtime that consumes a ``CapabilityTrace`` must index it by
    the client's *own* dispatch ordinal — NOT the round number — or
    clients that sit out rounds (adaptive cohorts, async scheduling)
    would skip trace entries and the run would stop being a pure
    function of ``(seed, cid, dispatch_index)``.  This helper owns those
    cursors; it replaces three hand-rolled ``dispatch_counts`` copies in
    ``fed/server.py``, ``fed/events.py``, and ``fed/fleet/batched.py``
    (the regression test in tests/test_obs.py pins the semantics).

    With ``trace=None`` the indexer still counts dispatches (telemetry
    wants the counts either way) and the perturbations are identities.
    """

    def __init__(self, n_clients: int, trace: CapabilityTrace | None):
        self.trace = trace
        self.counts = np.zeros(n_clients, dtype=np.int64)

    def begin(self, cid: int) -> int:
        """Allocate and return this dispatch's per-client ordinal."""
        k = int(self.counts[cid])
        self.counts[cid] += 1
        return k

    def capability(self, spec: ClientSpec, dispatch_index: int) -> float:
        if self.trace is None:
            return spec.c
        return self.trace.capability(spec, dispatch_index)

    def jitter(self, spec: ClientSpec, dispatch_index: int) -> float:
        if self.trace is None:
            return 1.0
        return self.trace.jitter(spec, dispatch_index)
