"""Named heterogeneity scenarios and the sweep entry point.

Which aggregation or participation rule wins depends on the *shape* of a
fleet's arrival process, not only its mean, so the JAX package keeps
reusable, named regimes.  Each ``Scenario`` pins (a) the static
capability distribution and (b) the time-varying ``TraceConfig``
(slowdown episodes + jitter) that together define a fleet's
heterogeneity.  ``build_scenario`` is numpy only and gives the JAX
package's ``ClientSpec``s and ``TraceConfig`` for every scenario and
seed.  ``run_scenario`` drives one scenario through a runtime.

Registry (all capability samplers are mean-≈1 so deadlines stay
comparable across scenarios):

  * ``uniform``          — the paper's N(1, 0.25) population, mild jitter.
  * ``pareto``           — Lomax(α=2) capabilities: a heavy tail of nearly-
                           dead devices and a few very fast ones.
  * ``diurnal``          — long correlated slow periods (devices charging /
                           busy for many consecutive dispatches).
  * ``flash_crowd``      — frequent short, severe contention spikes.
  * ``device_classes``   — a 3-class hardware mixture (low-end 0.3×,
                           mid 1×, flagship 3×) with per-device spread.

Runtimes: ``"sync"`` (``run_federated`` with ``FedCore``), ``"async"``
(``run_federated_async`` with ``FedCore``), ``"fleet"`` (``run_fleet``)
and ``"async_fleet"`` (``run_async_fleet``), the fleet ones with engines
``batched``, ``loop`` and ``sharded``, each with the fault axis and the
robust aggregators.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.fed.fleet.workloads import (FleetWorkload, client_sizes,
                                             get_workload)
from repro_torch.fed.simulator import ClientSpec, TraceConfig
from repro_torch.obs import get_recorder


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    capability_kind: str                  # normal | pareto | classes
    cap_params: Tuple[float, ...] = ()
    jitter_std: float = 0.1
    slowdown_prob: float = 0.03
    slowdown_factor: float = 3.0
    slowdown_mean_len: float = 3.0

    def sample_capabilities(self, n: int, rng: np.random.Generator,
                            floor: float = 0.05) -> np.ndarray:
        if self.capability_kind == "normal":
            mean, var = self.cap_params
            c = rng.normal(mean, np.sqrt(var), n)
        elif self.capability_kind == "pareto":
            (alpha,) = self.cap_params
            # Lomax(α): mean 1/(α−1); α=2 ⇒ mean 1 with a heavy slow tail
            c = rng.pareto(alpha, n)
        elif self.capability_kind == "classes":
            speeds = np.array(self.cap_params[0::2])
            probs = np.array(self.cap_params[1::2])
            cls = rng.choice(len(speeds), size=n, p=probs / probs.sum())
            # ±20% lognormal per-device spread within a hardware class
            c = speeds[cls] * rng.lognormal(-0.02, 0.2, n)
        else:
            raise ValueError(f"unknown capability_kind "
                             f"{self.capability_kind!r}")
        return np.maximum(c, floor)

    def trace_config(self, seed: int) -> TraceConfig:
        return TraceConfig(jitter_std=self.jitter_std,
                           slowdown_prob=self.slowdown_prob,
                           slowdown_factor=self.slowdown_factor,
                           slowdown_mean_len=self.slowdown_mean_len,
                           seed=seed)


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in [
    Scenario("uniform",
             "paper-default N(1, 0.25) capabilities, mild jitter",
             "normal", (1.0, 0.25),
             jitter_std=0.1, slowdown_prob=0.02),
    Scenario("pareto",
             "Lomax(2) heavy-tailed capabilities: many slow, few fast",
             "pareto", (2.0,),
             jitter_std=0.15, slowdown_prob=0.05),
    Scenario("diurnal",
             "long correlated slow episodes (charging/busy devices)",
             "normal", (1.0, 0.1),
             jitter_std=0.1, slowdown_prob=0.04, slowdown_factor=2.5,
             slowdown_mean_len=12.0),
    Scenario("flash_crowd",
             "frequent short severe contention spikes",
             "normal", (1.0, 0.15),
             jitter_std=0.25, slowdown_prob=0.2, slowdown_factor=5.0,
             slowdown_mean_len=2.0),
    Scenario("device_classes",
             "3-class hardware mixture: 20% 0.3x, 60% 1x, 20% 3x",
             "classes", (0.3, 0.2, 1.0, 0.6, 3.0, 0.2),
             jitter_std=0.12, slowdown_prob=0.03),
]}


def build_scenario(name: str, sizes: Sequence[int], seed: int = 0
                   ) -> Tuple[List[ClientSpec], TraceConfig]:
    """Materialize a named scenario for clients of the given data sizes."""
    scenario = SCENARIOS[name]
    # zlib.crc32, not hash(): str hashing is salted per process and would
    # break cross-run scenario determinism
    name_key = zlib.crc32(name.encode())
    rng = np.random.default_rng(np.random.SeedSequence((seed, name_key)))
    caps = scenario.sample_capabilities(len(sizes), rng)
    specs = [ClientSpec(cid=i, m=int(m), c=float(c))
             for i, (m, c) in enumerate(zip(sizes, caps))]
    return specs, scenario.trace_config(seed)


def run_scenario(name: str, runtime: str, model=None, clients_data=None,
                 test_data: Optional[Dict] = None, *, seed: int = 0,
                 rounds: int = 5, clients_per_round: int = 8,
                 epochs: int = 3, batch_size: int = 8, lr: float = 0.05,
                 straggler_pct: float = 30.0,
                 max_updates: Optional[int] = None, concurrency: int = 8,
                 scheduler=None, aggregator=None, faults=None,
                 fleet_engine: str = "batched",
                 use_kernel: Optional[bool] = None,
                 workload=None, n_clients: int = 24,
                 cost=None, verbose: bool = False,
                 device: DeviceLike = None) -> Dict[str, Any]:
    """Drive one named scenario through one runtime.

    ``runtime`` is ``"sync"`` (the synchronous round server,
    ``run_federated`` with the ``FedCore`` strategy), ``"async"`` (the
    event-driven runtime, ``run_federated_async`` with ``FedCore``: it
    applies ``max_updates`` server updates, default ``rounds ×
    clients_per_round``, with at most ``concurrency`` clients in flight
    and a record every ``clients_per_round`` updates), ``"fleet"``
    (``run_fleet``) or ``"async_fleet"`` (``run_async_fleet``: a flush
    every ``clients_per_round`` completions, ``max_updates`` flushes,
    default ``rounds``, with at least ``clients_per_round`` clients in
    flight); ``fleet_engine`` is ``"batched"``, ``"loop"`` or
    ``"sharded"`` (the ranks of the default process group; batched
    without one).
    Each consumes the same specs and capability trace from the registry,
    so a scenario means the same fleet in each.  ``use_kernel`` is the
    tri-state kernel switch of the coreset selection, threaded into the
    runtime's config.  ``workload`` is a registry name or a
    ``FleetWorkload``: it supplies the model (``model`` may then be
    omitted) and, without ``clients_data``, builds an ``n_clients``-client
    dataset from its own generator, validated against its schema.
    ``cost`` prices one sample-visit (see ``repro_torch.fed.cost``).
    ``device=None`` means the CUDA card.  The result dict gains
    ``scenario``, ``runtime``, ``faults`` and (with a workload)
    ``workload`` keys.

    ``faults`` is the fault axis (a ``FaultProfile``, a registry name
    like ``"byzantine_signflip"``, or None): its label-skew component
    repartitions ``clients_data`` (sizes kept, so specs and capability
    draws are unchanged) before the run, and the runtime axes (dropout,
    churn, corruption) go to the runtime.  ``aggregator`` takes a robust
    rule's name (``repro_torch.fed.aggregators.ROBUST_METHODS``) on every
    runtime; the async runtime also takes the streaming aggregators'
    names (``"fedasync"``, ``"fedbuff"``, ``"delayed_grad"``,
    ``"sync_mean"``) or an ``Aggregator``; the async fleet runtime the
    merge rules' names (``repro_torch.fed.fleet.ASYNC_MERGES``), a merge
    rule or a streaming aggregator (see ``as_merge_rule``).
    """
    from repro_torch.core.coreset import FedCoreConfig
    from repro_torch.fed.aggregators import (AGGREGATORS, ROBUST_METHODS,
                                             RobustAggregate,
                                             SyncWeightedMean)
    from repro_torch.fed.events import AsyncFLConfig, run_federated_async
    from repro_torch.fed.fleet.async_engine import (AsyncFleetConfig,
                                                    run_async_fleet)
    from repro_torch.fed.fleet.batched import FleetConfig, run_fleet
    from repro_torch.fed.fleet.faults import (dirichlet_label_skew,
                                              get_fault_profile)
    from repro_torch.fed.server import FLConfig, run_federated
    from repro_torch.fed.strategies import FedCore, LocalTrainer

    if runtime not in ("sync", "async", "fleet", "async_fleet"):
        raise ValueError(f"unknown runtime {runtime!r}")

    wl: Optional[FleetWorkload] = None
    if workload is not None:
        wl = (workload if isinstance(workload, FleetWorkload)
              else get_workload(workload))
        model = wl if model is None else model
        if clients_data is None:
            clients_data = wl.make_clients(n_clients=n_clients, seed=seed)
        wl.validate_clients(clients_data)
    if model is None or clients_data is None:
        raise ValueError("run_scenario needs model + clients_data, or a "
                         "workload to build them from")
    profile = get_fault_profile(faults)
    fault_name = profile.name if profile is not None else "none"
    if profile is not None and profile.label_skew_alpha is not None:
        # label skew repartitions the data but keeps per-client sizes, so
        # specs, budgets and capability draws are untouched
        clients_data = dirichlet_label_skew(
            clients_data, profile.label_skew_alpha, seed=seed)
    specs, trace = build_scenario(name, client_sizes(clients_data), seed)
    core_cfg = FedCoreConfig(use_kernel=use_kernel)
    # stamped before the runtime's own run record, so a JSONL log opens
    # with the scenario context
    get_recorder().event("scenario", scenario=name, runtime=runtime,
                         workload=(wl.name if wl is not None else None),
                         faults=fault_name, n_clients=len(specs), seed=seed)

    def streaming(round_size: int):
        """``aggregator`` as a streaming Aggregator for the async runtime
        (a robust name buffers one round's worth of updates before
        combining, as the sync server's round does)."""
        if aggregator is None or not isinstance(aggregator, str):
            return aggregator
        if aggregator in ROBUST_METHODS:
            return RobustAggregate(
                aggregator, round_size=round_size,
                layouts=getattr(model, "reference_layouts", None))
        if aggregator == "sync_mean":
            return SyncWeightedMean(round_size=round_size)
        return AGGREGATORS[aggregator]()

    # the sync and fleet runtimes take an aggregator by name; an
    # aggregator object is for the async runtime
    by_name = aggregator if isinstance(aggregator, str) else "weighted_mean"
    if runtime == "sync":
        cfg = FLConfig(rounds=rounds, clients_per_round=clients_per_round,
                       epochs=epochs, batch_size=batch_size, lr=lr,
                       straggler_pct=straggler_pct, seed=seed, trace=trace,
                       cost=cost)
        strat = FedCore(LocalTrainer(model, lr, batch_size, cost=cost,
                                     device=device), core_cfg)
        out = run_federated(model, clients_data, specs, strat, cfg,
                            test_data=test_data, scheduler=scheduler,
                            aggregator=by_name, faults=profile,
                            verbose=verbose, device=device)
    elif runtime == "async":
        cfg = AsyncFLConfig(
            max_updates=max_updates or rounds * clients_per_round,
            concurrency=concurrency, epochs=epochs, batch_size=batch_size,
            lr=lr, straggler_pct=straggler_pct,
            record_every=clients_per_round, seed=seed, trace=trace,
            cost=cost)
        strat = FedCore(LocalTrainer(model, lr, batch_size, cost=cost,
                                     device=device), core_cfg)
        out = run_federated_async(model, clients_data, specs, strat, cfg,
                                  aggregator=streaming(clients_per_round),
                                  test_data=test_data, scheduler=scheduler,
                                  faults=profile, verbose=verbose,
                                  device=device)
    elif runtime == "fleet":
        cfg = FleetConfig(epochs=epochs, batch_size=batch_size, lr=lr,
                          seed=seed, use_kernel=use_kernel, cost=cost,
                          aggregator=by_name)
        out = run_fleet(model, clients_data, specs, cfg, rounds=rounds,
                        scheduler=scheduler, trace=trace,
                        straggler_pct=straggler_pct, test_data=test_data,
                        engine=fleet_engine, faults=profile,
                        verbose=verbose, device=device)
    else:
        cfg = AsyncFleetConfig(
            max_updates=max_updates or rounds,
            buffer_k=clients_per_round,
            concurrency=max(concurrency, clients_per_round),
            epochs=epochs, batch_size=batch_size, lr=lr,
            straggler_pct=straggler_pct, seed=seed,
            use_kernel=use_kernel, trace=trace, cost=cost)
        out = run_async_fleet(model, clients_data, specs, cfg,
                              aggregator=aggregator, scheduler=scheduler,
                              test_data=test_data, engine=fleet_engine,
                              faults=profile, verbose=verbose,
                              device=device)
    out["scenario"] = name
    out["runtime"] = runtime
    out.setdefault("faults", fault_name)
    if wl is not None:
        out["workload"] = wl.name
    return out
