"""Event-driven asynchronous FL runtime (virtual clock).

The synchronous loop of ``repro_torch.fed.server`` ends a round at its
slowest participant.  This module runs asynchronous and semi-synchronous
FL (FedAsync, FedBuff, staleness-discounted delayed gradients) as a
discrete-event simulation:

  * a virtual-clock ``EventQueue`` orders DISPATCH/COMPLETE events by
    ``(time, seq)``, so ties break deterministically;
  * at most ``concurrency`` clients train at once; whenever a slot frees,
    the next idle client is sampled ∝ mⁱ and dispatched with the
    *current* global params;
  * a completion carries the model version it was dispatched from, so
    every update arrives with an exact staleness (in server versions)
    that the pluggable ``Aggregator`` can discount;
  * per-dispatch capability perturbations (``CapabilityTrace``) make the
    arrival process realistic rather than deterministic.

``run_federated_async`` drives any ``Strategy`` (FedAvg / FedProx /
FedCore) through this loop: a FedCore client in a slowdown episode
shrinks its coreset instead of stalling the server.  The clock is a
function of the seeds alone, kept in Python floats in the JAX package's
float64 order, and the numpy RNG is consumed in its order (the dispatch
draw, then the client's batching), so both packages write the same event
log byte for byte.
"""
from __future__ import annotations

import dataclasses
import heapq
import time as _time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.aggregators import Aggregator, ClientUpdate, FedAsync
from repro_torch.fed.server import RoundRecord, make_eval_fn
from repro_torch.fed.simulator import (CapabilityTrace, ClientSpec,
                                       DispatchTraceIndexer, TraceConfig,
                                       straggler_deadline)
from repro_torch.fed.strategies import Strategy
from repro_torch.obs import active_recorder

DISPATCH = "dispatch"
COMPLETE = "complete"


@dataclasses.dataclass(frozen=True)
class Event:
    time: float     # virtual seconds
    seq: int        # global push order — deterministic tie-break
    kind: str       # DISPATCH | COMPLETE
    cid: int
    version: int    # server model version at dispatch
    duration: float = 0.0   # realized training duration (COMPLETE only)

    def fmt(self) -> str:
        return (f"t={self.time!r} seq={self.seq} {self.kind} "
                f"cid={self.cid} v={self.version} dur={self.duration!r}")


class EventQueue:
    """Min-heap of events keyed by (time, seq)."""

    def __init__(self):
        self._heap: List[Any] = []
        self._seq = 0

    def push(self, time: float, kind: str, cid: int, version: int,
             duration: float = 0.0) -> Event:
        ev = Event(time, self._seq, kind, cid, version, duration)
        self._seq += 1
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def events(self) -> List[Event]:
        """The queued events, in no particular order."""
        return [e for _, _, e in self._heap]

    def __len__(self) -> int:
        return len(self._heap)


@dataclasses.dataclass
class AsyncFLConfig:
    max_updates: int = 100        # applied server updates (versions)
    max_virtual_time: Optional[float] = None  # stop once the clock passes this
    # dispatch safety cap so a run where no update can ever be applied
    # (e.g. every client drops) still terminates; None = auto
    max_dispatches: Optional[int] = None
    concurrency: int = 8          # in-flight client cap
    epochs: int = 5               # E
    batch_size: int = 8
    lr: float = 0.03
    straggler_pct: float = 30.0   # s (sets τ for deadline-aware strategies)
    deadline: Optional[float] = None
    record_every: int = 10        # history record every N applied updates
    eval_every: int = 1           # eval every Nth record
    seed: int = 0
    trace: Optional[TraceConfig] = None
    # per-sample step cost (repro_torch.fed.cost.WorkloadCostModel or
    # scalar; None = legacy): prices the derived deadline in the units the
    # strategy's LocalTrainer.cost prices client work
    cost: Any = None


def run_federated_async(model, clients_data: List[Dict[str, np.ndarray]],
                        specs: List[ClientSpec], strategy: Strategy,
                        cfg: AsyncFLConfig,
                        aggregator: Optional[Aggregator] = None,
                        test_data: Optional[Dict] = None, init_params=None,
                        eval_batch: int = 512, scheduler=None, faults=None,
                        verbose: bool = False,
                        device: DeviceLike = None) -> Dict[str, Any]:
    """Drive ``strategy`` through the async event loop until
    ``cfg.max_updates`` server updates have been applied.

    ``device=None`` means the CUDA card and must match the strategy's
    trainer device.  ``init_params`` (a flat dict of tensors) defaults to
    ``model.init`` from a ``torch.Generator`` seeded with ``cfg.seed``.
    ``aggregator`` defaults to ``FedAsync()``.  ``scheduler`` (optional)
    is an adaptive-participation policy with the ``eligible_mask`` /
    ``observe`` / ``record_round`` protocol of
    ``repro_torch.fed.fleet.scheduler.AdaptiveParticipation``: dispatch
    is restricted to its current cohort and it is fed every completion's
    realized (work, duration) pair.

    ``faults`` (a ``repro_torch.fed.fleet.faults`` profile, registry
    name, or None) injects seeded failures: mid-flight dropout discards a
    completion *after* its dispatch was accounted (the dispatch-trace
    cursor still advanced, so every other client's capability and jitter
    draws are unchanged), churn masks dispatch by the record window's
    presence mask, and Byzantine corruption rewrites a fixed client
    subset's updates against their dispatch snapshot before they reach
    the aggregator.

    Returns the same shape of result as ``run_federated`` plus
    ``event_log`` (list of strings), ``telemetry`` (utilization,
    staleness histogram, makespan) and ``version``."""
    # function-level import: repro_torch.fed.fleet imports the server
    from repro_torch.fed.fleet.faults import corrupt_update, make_fault_trace
    wall0 = _time.perf_counter()
    dev = resolve_device(device)
    if strategy.trainer.device != dev:
        raise ValueError(f"run_federated_async on {dev} but the strategy's "
                         f"trainer runs on {strategy.trainer.device}")
    rng = np.random.default_rng(cfg.seed)
    if init_params is None:
        init_params = model.init(torch.Generator().manual_seed(cfg.seed), dev)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in init_params.items()}
    deadline = cfg.deadline
    if deadline is None:
        deadline = straggler_deadline(specs, cfg.epochs, cfg.straggler_pct,
                                      cfg.cost)
    aggregator = aggregator if aggregator is not None else FedAsync()
    aggregator.reset()
    trace = CapabilityTrace(cfg.trace) if cfg.trace is not None else None
    dispatch_limit = (cfg.max_dispatches if cfg.max_dispatches is not None
                      else 50 * cfg.max_updates + 10 * cfg.concurrency)
    eval_fn = (make_eval_fn(model, test_data, eval_batch, device=dev)
               if test_data else None)

    n = len(specs)
    ftrace, fault_name = make_fault_trace(faults, n, cfg.seed)
    corruption = ftrace is not None and ftrace.profile.has_corruption
    layouts = getattr(model, "reference_layouts", None)
    sizes = np.array([s.m for s in specs], np.float64)
    busy = np.zeros(n, bool)
    busy_time = np.zeros(n)
    tracei = DispatchTraceIndexer(n, trace)
    obs = active_recorder(verbose)
    obs.run_meta(runtime="async", engine="async", strategy=strategy.name,
                 aggregator=aggregator.name, faults=fault_name, n_clients=n,
                 max_updates=cfg.max_updates, concurrency=cfg.concurrency,
                 deadline=float(deadline), seed=cfg.seed, device=str(dev))
    # cid -> (ClientResult | None, dispatch version, dispatch-time params,
    #         realized work units, dispatch ordinal)
    pending: Dict[int, Any] = {}

    queue = EventQueue()
    event_log: List[str] = []
    history: List[RoundRecord] = []
    staleness_log: List[int] = []

    version = 0
    applied = 0
    now = 0.0
    dropped_total = 0
    violations_total = 0
    # per-record accumulators
    rec_times: List[float] = []
    rec_losses: List[float] = []
    rec_rows: List[tuple] = []    # (cid, duration, dropped, violated)
    rec_coreset = 0
    rec_dropped = 0
    rec_violations = 0
    rec_applied = 0
    rec_start = 0.0
    rec_wall0 = _time.perf_counter()
    # the async "round" is a record window, not a lexical block, so the
    # round span is opened and closed at window boundaries
    round_span = obs.span_begin("round", round=0)

    def flush_record(t: float, eval_now: bool) -> None:
        nonlocal rec_times, rec_losses, rec_rows, rec_coreset, rec_dropped
        nonlocal rec_violations, rec_applied, rec_start, rec_wall0
        nonlocal round_span
        rec = RoundRecord(
            round=len(history), sim_round_time=t - rec_start,
            client_times=rec_times, n_participants=len(rec_times),
            n_dropped=rec_dropped, n_coreset=rec_coreset,
            train_loss=(float(np.mean(rec_losses)) if rec_losses
                        else float("nan")),
            n_violations=rec_violations)
        if eval_fn and eval_now:
            with obs.span("eval", round=rec.round):
                rec.test_acc, rec.test_loss = eval_fn(params)
        if scheduler is not None:
            scheduler.record_round(rec.train_loss)
        history.append(rec)
        obs.span_end(round_span)
        obs.event("round", runtime="async", engine="async",
                  label=f"{strategy.name}/{aggregator.name}",
                  round=rec.round, n_participants=rec.n_participants,
                  n_dropped=rec_dropped, n_coreset=rec_coreset,
                  n_violations=rec_violations,
                  sim_round_time=float(rec.sim_round_time),
                  wall_time_s=_time.perf_counter() - rec_wall0,
                  train_loss=float(rec.train_loss),
                  test_acc=float(rec.test_acc),
                  test_loss=float(rec.test_loss),
                  applied=applied, t_virtual=float(t))
        obs.event("clients", round=rec.round,
                  cids=[int(c) for c, _, _, _ in rec_rows],
                  durations=[d for _, d, _, _ in rec_rows],
                  dropped=[dr for _, _, dr, _ in rec_rows],
                  violated=[v for _, _, _, v in rec_rows])
        rec_times, rec_losses, rec_rows = [], [], []
        rec_coreset = rec_dropped = rec_violations = rec_applied = 0
        rec_start = t
        rec_wall0 = _time.perf_counter()
        round_span = obs.span_begin("round", round=len(history))

    n_dispatched = 0    # push-time count — the dispatch_limit gate
    churn_logged = -1   # last record window whose churn was counted

    def dispatch(t: float) -> bool:
        nonlocal n_dispatched, churn_logged
        if n_dispatched >= dispatch_limit:
            return False
        p = sizes * ~busy
        if scheduler is not None:
            p = p * scheduler.eligible_mask()
        if ftrace is not None and ftrace.profile.has_churn:
            # churn evolves per record window (the async "round")
            mask, joins, leaves = ftrace.churn_step(len(history))
            p = p * mask
            if churn_logged != len(history):
                churn_logged = len(history)
                obs.metrics.counter("faults.churn_joins").inc(joins)
                obs.metrics.counter("faults.churn_leaves").inc(leaves)
                obs.metrics.gauge("faults.n_present").set(int(mask.sum()))
        total = p.sum()
        if total == 0.0:
            return False
        cid = int(rng.choice(n, p=p / total))
        busy[cid] = True
        n_dispatched += 1
        queue.push(t, DISPATCH, cid, version)
        return True

    for _ in range(min(cfg.concurrency, n)):
        dispatch(0.0)

    unprocessed: List[Event] = []   # events past a max_virtual_time cutoff

    while len(queue) and applied < cfg.max_updates:
        ev = queue.pop()
        if (cfg.max_virtual_time is not None
                and ev.time > cfg.max_virtual_time):
            unprocessed.append(ev)
            break
        now = ev.time
        event_log.append(ev.fmt())

        if ev.kind == DISPATCH:
            spec = specs[ev.cid]
            k = tracei.begin(ev.cid)
            if trace is not None:
                spec = dataclasses.replace(
                    spec, c=tracei.capability(spec, k))
            with obs.span("local_update", cid=ev.cid):
                res = strategy.local_update(params, clients_data[ev.cid],
                                            spec, deadline, cfg.epochs, rng)
            obs.metrics.counter("dispatches").inc()
            if res is None:     # dropped straggler: slot blocked until τ
                duration = deadline
                work = spec.c * deadline
            else:
                duration = res.sim_time
                if trace is not None:
                    duration *= tracei.jitter(spec, k)
                work = res.sim_time * spec.c
            # staleness anchors at *processing* time, when the params
            # snapshot is taken — ev.version (push time) can lag it when
            # another completion applied an update at the same timestamp
            pending[ev.cid] = (res, version, params, work, k)
            queue.push(now + duration, COMPLETE, ev.cid, version, duration)
            continue

        # COMPLETE
        res, v0, base_params, work, k_idx = pending.pop(ev.cid)
        busy[ev.cid] = False
        busy_time[ev.cid] += ev.duration
        obs.metrics.histogram("client_busy_s").observe(ev.duration)
        if scheduler is not None:
            scheduler.observe(ev.cid, work, ev.duration)
        if res is None:
            dropped_total += 1
            rec_dropped += 1
            obs.metrics.counter("drops").inc()
            rec_rows.append((ev.cid, float(ev.duration), True, False))
        elif ftrace is not None and ftrace.dropped(ev.cid, k_idx):
            # fault-injected mid-flight dropout: the client trained, the
            # update is lost; its dispatch was already accounted (trace
            # cursor, busy time, scheduler), so surviving clients' draws
            # match the fault-free run
            dropped_total += 1
            rec_dropped += 1
            obs.metrics.counter("faults.dropped_updates").inc()
            rec_rows.append((ev.cid, float(ev.duration), True, False))
        else:
            violations_total += int(res.deadline_violated)
            rec_violations += int(res.deadline_violated)
            if res.deadline_violated:
                obs.metrics.counter("deadline_violations").inc()
            staleness = version - v0
            staleness_log.append(staleness)
            obs.metrics.histogram("staleness", exact=True).observe(staleness)
            rec_times.append(ev.duration)
            rec_losses.append(res.final_loss)
            rec_coreset += int(res.used_coreset)
            rec_rows.append((ev.cid, float(ev.duration), False,
                             bool(res.deadline_violated)))
            upd_params = res.params
            if corruption:
                # Byzantine clients rewrite their update relative to the
                # dispatch-time snapshot; honest updates pass untouched
                upd_params, was_corrupt = corrupt_update(
                    upd_params, base_params, ev.cid, k_idx, ftrace, layouts)
                if was_corrupt:
                    obs.metrics.counter("faults.corrupted_updates").inc()
            with obs.span("aggregate", cid=ev.cid):
                new_params = aggregator.apply(
                    params, ClientUpdate(params=upd_params,
                                         n_samples=res.n_samples,
                                         staleness=staleness,
                                         base_params=base_params))
            if new_params is not None:
                params = new_params
                version += 1
                applied += 1
                rec_applied += 1
                if (applied % cfg.record_every == 0
                        or applied == cfg.max_updates):
                    flush_record(now, eval_now=(
                        len(history) % cfg.eval_every == 0
                        or applied == cfg.max_updates))
        if applied < cfg.max_updates:
            dispatch(now)

    # tail drain: a partially filled aggregator buffer (FedBuff /
    # semi-sync) holds real completed client work — merge it rather than
    # drop it at a cutoff or when the queue runs dry
    if applied < cfg.max_updates:
        tail = aggregator.flush(params)
        if tail is not None:
            params = tail
            version += 1
            applied += 1
            rec_applied += 1
            obs.metrics.counter("aggregator.partial_flushes").inc()

    # partial record at a cutoff: applied-but-unrecorded updates, tail
    # drops, or contributions still sitting in an aggregator buffer
    if rec_applied or rec_times or rec_dropped:
        flush_record(now, eval_now=True)
    obs.span_end(round_span)    # the (possibly empty) trailing window

    makespan = now
    # credit clients still mid-training at termination for the busy time
    # they accrued inside [0, makespan] (their COMPLETE never processed)
    for ev in unprocessed + queue.events():
        if ev.kind == COMPLETE and ev.cid in pending:
            busy_time[ev.cid] += max(0.0, ev.duration - (ev.time - makespan))
    active = tracei.counts > 0
    hist = (np.bincount(staleness_log) if staleness_log
            else np.zeros(1, np.int64))
    telemetry = {
        "makespan": float(makespan),
        "client_utilization": float(busy_time.sum()
                                    / max(n * makespan, 1e-12)),
        "active_client_utilization": float(
            busy_time[active].sum()
            / max(active.sum() * makespan, 1e-12)) if active.any() else 0.0,
        "staleness_hist": hist,
        "mean_staleness": (float(np.mean(staleness_log))
                           if staleness_log else 0.0),
        "max_staleness": int(hist.size - 1),
        "n_dispatches": int(tracei.counts.sum()),
        "n_updates_applied": applied,
        "n_dropped": dropped_total,
        "n_violations": violations_total,
        "wall_time": _time.perf_counter() - wall0,
    }
    if obs.enabled:
        obs.event("telemetry", **{k: (v.tolist() if isinstance(v, np.ndarray)
                                      else v) for k, v in telemetry.items()})
        obs.metrics.gauge("client_utilization").set(
            telemetry["client_utilization"])
        obs.metrics.gauge("active_client_utilization").set(
            telemetry["active_client_utilization"])
        obs.metrics.gauge("makespan_virtual_s").set(telemetry["makespan"])
    return {
        "params": params,
        "history": history,
        "deadline": deadline,
        "strategy": strategy.name,
        "aggregator": aggregator.name,
        "faults": fault_name,
        "version": version,
        "event_log": event_log,
        "telemetry": telemetry,
    }
