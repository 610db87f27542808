"""Federated server: round loop, client sampling, aggregation, history.

Implements Alg. 1's outer loop: sample K clients ∝ pⁱ = mⁱ/Σm with
replacement (Assumption A.6), broadcast (w_r, τ), collect local updates via
the strategy, aggregate w_{r+1} = (1/K) Σ w_rⁱ (Σ mⁱ w_rⁱ / Σ mⁱ with
``weight_by_samples=True``).  The numpy RNG is consumed in the JAX
package's order — the cohort draw, then each client's batching — so the
same seed gives both packages the same cohorts and batches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.aggregators import (ROBUST_METHODS, SyncWeightedMean,
                                         robust_combine, stack_params)
from repro_torch.fed.simulator import (CapabilityTrace, ClientSpec,
                                       DispatchTraceIndexer, TraceConfig,
                                       straggler_deadline)
from repro_torch.fed.strategies import ClientResult, Strategy
from repro_torch.obs import active_recorder


@dataclasses.dataclass
class FLConfig:
    rounds: int = 20
    clients_per_round: int = 10
    epochs: int = 10              # E
    batch_size: int = 8
    lr: float = 0.03
    straggler_pct: float = 30.0   # s
    deadline: Optional[float] = None  # τ; None => derived from straggler_pct
    eval_every: int = 1
    seed: int = 0
    # aggregate ∝ mⁱ. Default False: with clients sampled ∝ mⁱ with
    # replacement (Assumption A.6) the unbiased Alg. 1 aggregate is the
    # uniform 1/K mean — weighting by mⁱ again would double-count size.
    weight_by_samples: bool = False
    # per-dispatch capability perturbations (slowdown episodes + jitter)
    trace: Optional[TraceConfig] = None
    # per-sample step cost (repro_torch.fed.cost.WorkloadCostModel or
    # scalar; None = legacy samples-cost-1.0)
    cost: Any = None


@dataclasses.dataclass
class RoundRecord:
    round: int
    sim_round_time: float          # max over participating clients
    client_times: List[float]
    n_participants: int
    n_dropped: int
    n_coreset: int
    train_loss: float
    test_acc: float = float("nan")
    test_loss: float = float("nan")
    wall_time: float = 0.0
    n_violations: int = 0          # results flagged deadline_violated


def sample_clients(specs: Sequence[ClientSpec], k: int,
                   rng: np.random.Generator) -> List[int]:
    p = np.array([s.m for s in specs], np.float64)
    p /= p.sum()
    return list(rng.choice(len(specs), size=k, replace=True, p=p))


def run_federated(model, clients_data: List[Dict[str, np.ndarray]],
                  specs: List[ClientSpec], strategy: Strategy,
                  cfg: FLConfig, test_data: Optional[Dict] = None,
                  init_params=None, eval_batch: int = 512,
                  scheduler=None, aggregator: str = "weighted_mean",
                  faults=None, verbose: bool = False,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """Synchronous Alg. 1 round loop.

    ``device=None`` means the CUDA card and must match the strategy's
    trainer device.  ``init_params`` (a flat dict of tensors) defaults to
    ``model.init`` from a ``torch.Generator`` seeded with ``cfg.seed``.
    ``cfg.trace`` perturbs each dispatch's capability.  ``scheduler``
    (optional) is an adaptive-participation policy with the ``select`` /
    ``observe`` / ``record_round`` protocol of
    ``repro_torch.fed.fleet.scheduler.AdaptiveParticipation``: it replaces
    ∝ mⁱ sampling with its own cohort and is fed realized durations.

    ``aggregator`` selects the round merge: ``"weighted_mean"`` (Alg. 1)
    or a robust rule of ``repro_torch.fed.aggregators.ROBUST_METHODS``.
    ``faults`` (a ``repro_torch.fed.fleet.faults`` profile or name)
    injects seeded dropout, churn and Byzantine corruption without
    changing a surviving client's capability draws: churn filters the
    cohort after the sampling draw, a dropped update's client still
    holds the round until it finishes, and corruption is taken against
    the round-start params.
    """
    # function-level import: repro_torch.fed.fleet imports this module
    from repro_torch.fed.fleet.faults import corrupt_update, make_fault_trace
    if aggregator != "weighted_mean" and aggregator not in ROBUST_METHODS:
        raise ValueError(
            f"unknown sync aggregator {aggregator!r} (expected "
            f"'weighted_mean' or one of {sorted(ROBUST_METHODS)})")
    dev = resolve_device(device)
    if strategy.trainer.device != dev:
        raise ValueError(f"run_federated on {dev} but the strategy's "
                         f"trainer runs on {strategy.trainer.device}")
    rng = np.random.default_rng(cfg.seed)
    if init_params is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        init_params = model.init(gen, dev)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in init_params.items()}
    deadline = cfg.deadline
    if deadline is None:
        deadline = straggler_deadline(specs, cfg.epochs, cfg.straggler_pct,
                                      cfg.cost)

    history: List[RoundRecord] = []
    eval_fn = (make_eval_fn(model, test_data, eval_batch, device=dev)
               if test_data else None)
    mean_agg = SyncWeightedMean(cfg.weight_by_samples)
    trace = CapabilityTrace(cfg.trace) if cfg.trace is not None else None
    tracei = DispatchTraceIndexer(len(specs), trace)
    ftrace, fault_name = make_fault_trace(faults, len(specs), cfg.seed)
    layouts = getattr(model, "reference_layouts", None)
    obs = active_recorder(verbose)
    obs.run_meta(runtime="sync", engine="sync", strategy=strategy.name,
                 aggregator=aggregator, faults=fault_name,
                 n_clients=len(specs), rounds=cfg.rounds,
                 deadline=float(deadline), seed=cfg.seed)

    for r in range(cfg.rounds):
        t0 = time.perf_counter()
        rspan = obs.span_begin("round", round=r)
        with obs.span("cohort_select", round=r):
            if scheduler is not None:
                selected = [int(c) for c in scheduler.select()]
            else:
                selected = sample_clients(specs, cfg.clients_per_round, rng)
            if ftrace is not None and ftrace.profile.has_churn:
                # churned-out clients miss the round; the sampling draw
                # above already happened, so the survivors' RNG streams
                # match the churn-free run
                mask, joins, leaves = ftrace.churn_step(r)
                selected = [c for c in selected if mask[c]]
                obs.metrics.counter("faults.churn_joins").inc(joins)
                obs.metrics.counter("faults.churn_leaves").inc(leaves)
                obs.metrics.gauge("faults.n_present").set(int(mask.sum()))
        results: List[ClientResult] = []
        times: List[float] = []
        drop_times: List[float] = []
        dropped = 0
        n_corrupted = 0
        client_rows = []    # (cid, sim duration, dropped, violated)
        with obs.span("local_update", round=r):
            for cid in selected:
                spec = specs[cid]
                k = tracei.begin(cid)
                if trace is not None:
                    spec = dataclasses.replace(spec,
                                               c=tracei.capability(spec, k))
                res = strategy.local_update(params, clients_data[cid], spec,
                                            deadline, cfg.epochs, rng)
                obs.metrics.counter("dispatches").inc()
                if res is None:
                    dropped += 1
                    obs.metrics.counter("drops").inc()
                    client_rows.append((cid, float(deadline), True, False))
                    # dropped stragglers in FedAvg-DS still busy until τ
                    drop_times.append(float(deadline))
                    if scheduler is not None:   # a drop still occupies τ
                        scheduler.observe(cid, spec.c * deadline, deadline)
                else:
                    duration = res.sim_time
                    if trace is not None:
                        duration *= tracei.jitter(spec, k)
                    if scheduler is not None:
                        scheduler.observe(cid, res.sim_time * spec.c,
                                          duration)
                    if ftrace is not None and ftrace.dropped(cid, k):
                        # fault dropout: the client trained (its trace
                        # cursor advanced, the round waits for it) but
                        # the update never reaches the server
                        dropped += 1
                        obs.metrics.counter("faults.dropped_updates").inc()
                        client_rows.append((cid, float(duration), True,
                                            False))
                        drop_times.append(float(duration))
                        continue
                    if ftrace is not None and ftrace.profile.has_corruption:
                        cp, was_c = corrupt_update(res.params, params, cid,
                                                   k, ftrace, layouts)
                        if was_c:
                            n_corrupted += 1
                            obs.metrics.counter(
                                "faults.corrupted_updates").inc()
                            res = dataclasses.replace(res, params=cp)
                    results.append(res)
                    times.append(duration)
                    obs.metrics.histogram("client_busy_s").observe(duration)
                    if res.deadline_violated:
                        obs.metrics.counter("deadline_violations").inc()
                    client_rows.append((cid, float(duration), False,
                                        bool(res.deadline_violated)))

        with obs.span("aggregate", round=r):
            if results and aggregator == "weighted_mean":
                params = mean_agg.aggregate(
                    [r_.params for r_ in results],
                    [r_.n_samples for r_ in results],
                    fallback=params)
            elif results:
                weights = ([r_.n_samples for r_ in results]
                           if cfg.weight_by_samples else None)
                params = robust_combine(
                    stack_params([r_.params for r_ in results]),
                    aggregator, weights=weights, base=params,
                    layouts=layouts)
        round_time = max(times + drop_times + [0.0])
        train_loss = float(np.mean([r_.final_loss for r_ in results])
                           ) if results else float("nan")
        if scheduler is not None:
            scheduler.record_round(train_loss)
        rec = RoundRecord(
            round=r, sim_round_time=round_time, client_times=times,
            n_participants=len(results), n_dropped=dropped,
            n_coreset=sum(r_.used_coreset for r_ in results),
            train_loss=train_loss, wall_time=time.perf_counter() - t0,
            n_violations=sum(r_.deadline_violated for r_ in results))
        if eval_fn and (r % cfg.eval_every == 0 or r == cfg.rounds - 1):
            with obs.span("eval", round=r):
                rec.test_acc, rec.test_loss = eval_fn(params)
        history.append(rec)
        obs.span_end(rspan)
        obs.event("round", runtime="sync", engine="sync",
                  label=strategy.name, round=r,
                  n_participants=rec.n_participants, n_dropped=dropped,
                  n_corrupted=n_corrupted,
                  n_coreset=rec.n_coreset, n_violations=rec.n_violations,
                  sim_round_time=float(round_time),
                  wall_time_s=time.perf_counter() - t0,
                  train_loss=float(train_loss),
                  test_acc=float(rec.test_acc),
                  test_loss=float(rec.test_loss))
        obs.event("clients", round=r,
                  cids=[int(c) for c, _, _, _ in client_rows],
                  durations=[d for _, d, _, _ in client_rows],
                  dropped=[dr for _, _, dr, _ in client_rows],
                  violated=[v for _, _, _, v in client_rows])

    return {
        "params": params,
        "history": history,
        "deadline": deadline,
        "strategy": strategy.name,
        "aggregator": aggregator,
        "faults": fault_name,
    }


def make_eval_fn(model, test_data, eval_batch: int,
                 device: DeviceLike = None):
    """Batched test-set (accuracy, loss) closure."""
    dev = resolve_device(device)

    def eval_fn(params):
        m = len(next(iter(test_data.values())))
        accs, losses, ns = [], [], []
        with torch.no_grad():
            for lo in range(0, m, eval_batch):
                batch = {k: torch.as_tensor(v[lo:lo + eval_batch],
                                            device=dev)
                         for k, v in test_data.items()}
                a = model.accuracy(params, batch)
                l = model.loss(params, batch)[0]
                n = len(next(iter(batch.values())))
                accs.append(float(a) * n)
                losses.append(float(l) * n)
                ns.append(n)
        return sum(accs) / sum(ns), sum(losses) / sum(ns)

    return eval_fn


def summarize(history: List[RoundRecord], deadline: float) -> Dict[str, float]:
    if not history:
        return {k: float("nan") for k in (
            "mean_round_time", "mean_round_time_normalized",
            "max_round_time_normalized", "final_test_acc", "best_test_acc",
            "final_train_loss")}
    times = np.array([h.sim_round_time for h in history])
    accs = np.array([h.test_acc for h in history])
    accs = accs[~np.isnan(accs)]
    return {
        "mean_round_time": float(times.mean()),
        "mean_round_time_normalized": float(times.mean() / deadline),
        "max_round_time_normalized": float(times.max() / deadline),
        "final_test_acc": float(accs[-1]) if len(accs) else float("nan"),
        "best_test_acc": float(accs.max()) if len(accs) else float("nan"),
        "final_train_loss": float(history[-1].train_loss),
    }
