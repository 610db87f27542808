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

Ported runtimes: ``"sync"`` (``run_federated`` with ``FedCore``) and
``"fleet"`` (``run_fleet``, engines ``batched`` and ``loop``).  Not
ported yet, each raising ``NotImplementedError``: the ``"async"`` and
``"async_fleet"`` runtimes (ROADMAP item 11), every ``faults`` profile
but ``"none"`` and the robust aggregators (item 12), and
``fleet_engine="sharded"`` (item 15, raised by ``run_fleet``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.fed.faults import check_no_faults
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
                 scheduler=None, aggregator=None, faults=None,
                 fleet_engine: str = "batched",
                 use_kernel: Optional[bool] = None,
                 workload=None, n_clients: int = 24,
                 cost=None, verbose: bool = False,
                 device: DeviceLike = None) -> Dict[str, Any]:
    """Drive one named scenario through one runtime.

    ``runtime`` is ``"sync"`` (the synchronous round server,
    ``run_federated`` with the ``FedCore`` strategy) or ``"fleet"``
    (``run_fleet``; ``fleet_engine`` is ``"batched"`` or ``"loop"``).
    Both consume the same specs and capability trace from the registry,
    so a scenario means the same fleet in each.  ``use_kernel`` is the
    tri-state kernel switch of the coreset selection, threaded into the
    runtime's config.  ``workload`` is a registry name or a
    ``FleetWorkload``: it supplies the model (``model`` may then be
    omitted) and, without ``clients_data``, builds an ``n_clients``-client
    dataset from its own generator, validated against its schema.
    ``cost`` prices one sample-visit (see ``repro_torch.fed.cost``).
    ``device=None`` means the CUDA card.  The result dict gains
    ``scenario``, ``runtime``, ``faults`` and (with a workload)
    ``workload`` keys.  The JAX package's ``max_updates`` and
    ``concurrency`` belong to its async runtimes and come with them.

    Not ported yet, each raising ``NotImplementedError``: the ``"async"``
    and ``"async_fleet"`` runtimes (ROADMAP item 11), ``faults`` other
    than None and ``"none"`` and aggregators other than
    ``"weighted_mean"`` (item 12),
    ``fleet_engine="sharded"`` (item 15).
    """
    from repro_torch.core.coreset import FedCoreConfig
    from repro_torch.fed.fleet.batched import FleetConfig, run_fleet
    from repro_torch.fed.server import FLConfig, run_federated
    from repro_torch.fed.strategies import FedCore, LocalTrainer

    if runtime in ("async", "async_fleet"):
        raise NotImplementedError(
            f"the {runtime!r} runtime is not ported yet: ROADMAP item 11")
    if runtime not in ("sync", "fleet"):
        raise ValueError(f"unknown runtime {runtime!r}")
    check_no_faults(faults)
    # the sync and fleet runtimes take an aggregator by name; an
    # aggregator object is for the async runtimes, as in the JAX package
    agg = aggregator if isinstance(aggregator, str) else "weighted_mean"
    if agg != "weighted_mean":
        raise NotImplementedError(
            f"aggregator {agg!r} is not ported yet: robust aggregation is "
            "ROADMAP item 12 (only 'weighted_mean')")

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
    specs, trace = build_scenario(name, client_sizes(clients_data), seed)
    # stamped before the runtime's own run record, so a JSONL log opens
    # with the scenario context
    get_recorder().event("scenario", scenario=name, runtime=runtime,
                         workload=(wl.name if wl is not None else None),
                         faults="none", n_clients=len(specs), seed=seed)

    if runtime == "sync":
        cfg = FLConfig(rounds=rounds, clients_per_round=clients_per_round,
                       epochs=epochs, batch_size=batch_size, lr=lr,
                       straggler_pct=straggler_pct, seed=seed, trace=trace,
                       cost=cost)
        strat = FedCore(LocalTrainer(model, lr, batch_size, cost=cost,
                                     device=device),
                        FedCoreConfig(use_kernel=use_kernel))
        out = run_federated(model, clients_data, specs, strat, cfg,
                            test_data=test_data, scheduler=scheduler,
                            aggregator=agg, verbose=verbose, device=device)
    else:
        cfg = FleetConfig(epochs=epochs, batch_size=batch_size, lr=lr,
                          seed=seed, use_kernel=use_kernel, cost=cost,
                          aggregator=agg)
        out = run_fleet(model, clients_data, specs, cfg, rounds=rounds,
                        scheduler=scheduler, trace=trace,
                        straggler_pct=straggler_pct, test_data=test_data,
                        engine=fleet_engine, verbose=verbose, device=device)
    out["scenario"] = name
    out["runtime"] = runtime
    out.setdefault("faults", "none")
    if wl is not None:
        out["workload"] = wl.name
    return out
