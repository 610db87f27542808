"""Event-driven async fleet engine: micro-batched cohort rounds at scale.

The async runtime (``repro_torch.fed.events``) steps one client per
completion; the fleet engine (``repro_torch.fed.fleet.batched``) runs
barrier-synchronous rounds.  This module joins them:

  * the virtual-clock ``EventQueue`` orders DISPATCH/COMPLETE events as
    in ``repro_torch.fed.events``, but a completion trains nothing: it
    lands in a server-side **buffer** (FedBuff-style buffered-K, Nguyen
    et al. 2022);
  * when the buffer holds ``buffer_k`` completions, the engine
    **micro-batches** them into padded same-shape cohort groups
    (``make_cohort_groups``: the grouping, padding and seeded per-client
    permutations of the sync fleet path) and runs each group through
    ``FleetEngine.run_group`` from inside the event loop, so group
    dispatches scale with the number of distinct (M, k) shapes a flush
    holds, not with its clients;
  * each buffered update carries an exact **staleness** (server versions,
    i.e. flushes, between its dispatch and its merge), and the global
    params it was dispatched from stay pinned (refcounted) until every
    client trained from them has been merged, so groups train from their
    true dispatch-time snapshots;
  * the merge goes through a staleness-aware **merge rule**, the
    vectorized form of the streaming ``repro_torch.fed.aggregators``:
    every linear rule reduces to ``new = c_w * w_global + sum_i c_i *
    w_i`` (plus dispatch-snapshot terms for delayed gradients), one
    ``weighted_param_sum`` per group; a robust rule hands the flush's
    concatenated stacks to ``robust_combine``;
  * the adaptive scheduler (``AdaptiveParticipation``) plugs into the
    same ``eligible_mask`` / ``observe`` / ``budget`` / ``record_round``
    protocol: dispatch waves weight clients by its mask, every
    completion feeds its capability EWMA, and per-dispatch coreset
    budgets come from observed capability between flushes.

Client training time is accounted analytically (work units / effective
capability x trace jitter), as in the sync fleet driver, so the event
schedule, and therefore the event log, is a pure function of ``(seed,
specs, trace, scheduler state)``: Python floats in the JAX package's
float64 order and the numpy generator consumed in its order.  Both
engines and the JAX package write the same log byte for byte.

Staleness is measured in flushes (server versions), as every merge rule
discounts it.  ``FedAsyncMerge`` applies its per-update sequential
mixing in closed form over the buffer, so a flush of K updates
reproduces K sequential ``FedAsync.apply`` calls with those staleness
values.  No step of a flush writes into a tensor it was given: pinned
snapshots stay valid for every later group that trains from them.

Checkpoints are taken between flush windows, never on a partial flush:
the params and every pinned dispatch snapshot in one npz, the virtual
clock, buffers, logs, counters, RNG and scheduler state in its JSON
meta, so a resumed run replays the continuation wave and every later
event byte for byte.  ``engine="sharded"`` runs each flush's groups
split across the ranks of a process group, each group's
coefficient-weighted parameter sum all-reduced
(``repro_torch.fed.fleet.sharded``).
"""
from __future__ import annotations

import dataclasses
import functools
import time as _time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (load_server_meta, load_server_state,
                                    save_server_state)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.aggregators import (ROBUST_METHODS, DelayedGradient,
                                         FedAsync, FedBuff, RobustAggregate,
                                         robust_combine)
from repro_torch.fed.cost import resolve_cost
from repro_torch.fed.events import COMPLETE, DISPATCH, Event, EventQueue
from repro_torch.fed.fleet.batched import (FleetConfig, FleetEngine,
                                           _floor_pow4, make_cohort_groups,
                                           weighted_param_sum)
from repro_torch.fed.fleet.faults import corrupt_stacked, make_fault_trace
from repro_torch.fed.server import RoundRecord, make_eval_fn
from repro_torch.fed.simulator import (CapabilityTrace, ClientSpec,
                                       DispatchTraceIndexer, TraceConfig,
                                       straggler_deadline)
from repro_torch.obs import (NULL_RECORDER, active_recorder, get_recorder,
                             use_recorder)
from repro_torch.utils.tree import tree_add, tree_scale

ClientData = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class AsyncFleetConfig:
    """Event-loop and local-training knobs of the async fleet engine.

    One applied server update is one buffer **flush** (a micro-batched
    merge of ``buffer_k`` completions), so ``max_updates`` counts
    flushes: the analogue of rounds, not of single-client updates as in
    ``AsyncFLConfig``."""
    max_updates: int = 20         # applied flushes (server versions)
    max_virtual_time: Optional[float] = None  # stop past this clock value
    buffer_k: int = 8             # completions per merge (FedBuff K)
    concurrency: int = 16         # in-flight client cap
    epochs: int = 2               # E
    batch_size: int = 8
    lr: float = 0.05
    use_kernel: Optional[bool] = None   # tri-state selection-kernel switch
    # distance-free selection (see FleetConfig.distance_free): on by
    # default, False keeps the materializing (C, M, M) path;
    # materialize_below is the small-M cutover
    distance_free: bool = True
    materialize_below: int = 256
    max_sweeps: int = 25
    weight_by_samples: bool = True
    straggler_pct: float = 30.0
    deadline: Optional[float] = None
    eval_every: int = 1           # eval every Nth flush
    seed: int = 0
    trace: Optional[TraceConfig] = None
    # per-sample step cost (repro_torch.fed.cost.WorkloadCostModel or
    # scalar; None = legacy samples-cost-1.0): prices budgets, the derived
    # deadline and realized dispatch durations
    cost: Any = None

    def fleet_config(self) -> FleetConfig:
        """The grouping and training config shared with the sync fleet
        path (the same perms, padding and group programs)."""
        return FleetConfig(epochs=self.epochs, batch_size=self.batch_size,
                           lr=self.lr, use_kernel=self.use_kernel,
                           distance_free=self.distance_free,
                           materialize_below=self.materialize_below,
                           max_sweeps=self.max_sweeps,
                           weight_by_samples=self.weight_by_samples,
                           seed=self.seed, cost=self.cost)


# ---------------------------------------------------------------------------
# merge rules: the streaming aggregators, vectorized over a buffer
# ---------------------------------------------------------------------------

class AsyncMergeRule:
    """One buffer flush as a linear combination.

    ``coefficients(staleness, n_samples)`` returns float64 ``(c, c_w)``
    such that the merged params are

        new = c_w * w_global + sum_i c_i * w_i          (use_base=False)
        new = w_global + sum_i c_i * (w_i - base_i)     (use_base=True)

    with ``w_i`` the buffered client params in **arrival order** and
    ``base_i`` the dispatch-time global snapshot of update i.  The
    engine evaluates the sums as one ``weighted_param_sum`` per cohort
    group, so the merge never loops over clients host-side."""
    name = "base"
    use_base = False    # True: coefficients weight deltas from dispatch
    robust = False      # True: the flush goes through robust_combine

    def coefficients(self, staleness: np.ndarray, n_samples: np.ndarray
                     ) -> Tuple[np.ndarray, float]:
        raise NotImplementedError


class FedBuffMerge(AsyncMergeRule):
    """FedBuff (Nguyen et al., 2022): the staleness-discounted weighted
    mean of the buffer, mixed in with server learning-rate eta; the
    streaming ``FedBuff`` on a full buffer, and on a partial one through
    the engine's final drain."""
    name = "fedbuff"

    def __init__(self, staleness_exponent: float = 0.5,
                 server_lr: float = 1.0, weight_by_samples: bool = False):
        if not 0.0 < server_lr <= 1.0:
            raise ValueError(f"server_lr must be in (0, 1], got {server_lr}")
        self.staleness_exponent = staleness_exponent
        self.server_lr = server_lr
        self.weight_by_samples = weight_by_samples

    def coefficients(self, staleness, n_samples):
        w = (1.0 + staleness.astype(np.float64)) ** -self.staleness_exponent
        if self.weight_by_samples:
            w = w * n_samples.astype(np.float64)
        c = self.server_lr * w / w.sum()
        return c, 1.0 - self.server_lr


class FedAsyncMerge(AsyncMergeRule):
    """FedAsync (Xie et al., 2019) sequential mixing in closed form.

    Applying w <- (1 - a_i) w + a_i w_i for i = 1..K telescopes to

        c_w = prod_j (1 - a_j),    c_i = a_i * prod_{j>i} (1 - a_j)

    so one vectorized flush reproduces K sequential ``FedAsync.apply``
    calls to float32 summation tolerance."""
    name = "fedasync"

    def __init__(self, mixing: float = 0.6, staleness_exponent: float = 0.5):
        if not 0.0 < mixing <= 1.0:
            raise ValueError(f"mixing must be in (0, 1], got {mixing}")
        self.mixing = mixing
        self.staleness_exponent = staleness_exponent

    def coefficients(self, staleness, n_samples):
        a = self.mixing * (1.0 + staleness.astype(np.float64)
                           ) ** -self.staleness_exponent
        keep = np.cumprod((1.0 - a)[::-1])[::-1]   # keep[i] = prod_{j>=i}
        tail = np.concatenate([keep[1:], [1.0]])   # tail[i] = prod_{j>i}
        return a * tail, float(keep[0])


class DelayedGradientMerge(AsyncMergeRule):
    """Staleness-discounted delayed deltas (arXiv 2102.06329):
    w <- w + sum_i eta * (1 + t_i)^{-a} * (w_i - base_i)."""
    name = "delayed_grad"
    use_base = True

    def __init__(self, server_lr: float = 1.0,
                 staleness_exponent: float = 0.5):
        self.server_lr = server_lr
        self.staleness_exponent = staleness_exponent

    def coefficients(self, staleness, n_samples):
        c = self.server_lr * (1.0 + staleness.astype(np.float64)
                              ) ** -self.staleness_exponent
        return c, 1.0


class RobustMerge(AsyncMergeRule):
    """Byzantine-robust flush: the buffered client params are stacked and
    combined with a robust estimator of ``repro_torch.fed.aggregators``
    (trimmed mean, median, Krum, multi-Krum, norm clipping), then mixed
    into the global params with ``server_lr``: the async counterpart of
    ``RobustAggregate``, the estimator seeing one flush as the sync rule
    sees one round."""
    name = "robust"
    robust = True

    def __init__(self, method: str, server_lr: float = 1.0,
                 weight_by_samples: bool = True, trim_frac: float = 0.1,
                 n_byzantine: Optional[int] = None):
        if method not in ROBUST_METHODS:
            raise ValueError(f"unknown robust merge method {method!r} "
                             f"(expected one of {sorted(ROBUST_METHODS)})")
        if not 0.0 < server_lr <= 1.0:
            raise ValueError(f"server_lr must be in (0, 1], got {server_lr}")
        self.method = method
        self.name = method
        self.server_lr = server_lr
        self.weight_by_samples = weight_by_samples
        self.trim_frac = trim_frac
        self.n_byzantine = n_byzantine

    def coefficients(self, staleness, n_samples):
        # never used on the robust path: zeros make a linear evaluation a
        # no-op that keeps the base params
        return np.zeros(len(staleness), np.float64), 1.0


ASYNC_MERGES = {
    "fedbuff": FedBuffMerge,
    "fedasync": FedAsyncMerge,
    "delayed_grad": DelayedGradientMerge,
    **{m: functools.partial(RobustMerge, m) for m in ROBUST_METHODS},
}


def as_merge_rule(aggregator) -> AsyncMergeRule:
    """Coerce an aggregator spec into a merge rule.

    Accepts ``None`` (FedBuff defaults), a registry name, an
    ``AsyncMergeRule``, or a streaming ``repro_torch.fed.aggregators``
    instance (``FedBuff``, ``FedAsync``, ``DelayedGradient``,
    ``RobustAggregate``), whose hyperparameters carry over, so a caller
    can hand the same aggregator object to the async and async_fleet
    runtimes."""
    if aggregator is None:
        return FedBuffMerge()
    if isinstance(aggregator, AsyncMergeRule):
        return aggregator
    if isinstance(aggregator, str):
        try:
            return ASYNC_MERGES[aggregator]()
        except KeyError:
            raise ValueError(
                f"unknown async merge rule {aggregator!r} "
                f"(expected one of {sorted(ASYNC_MERGES)})") from None
    if isinstance(aggregator, FedBuff):
        return FedBuffMerge(staleness_exponent=aggregator.staleness_exponent,
                            server_lr=aggregator.server_lr,
                            weight_by_samples=aggregator.weight_by_samples)
    if isinstance(aggregator, FedAsync):
        return FedAsyncMerge(mixing=aggregator.mixing,
                             staleness_exponent=aggregator.staleness_exponent)
    if isinstance(aggregator, DelayedGradient):
        return DelayedGradientMerge(
            server_lr=aggregator.server_lr,
            staleness_exponent=aggregator.staleness_exponent)
    if isinstance(aggregator, RobustAggregate):
        return RobustMerge(aggregator.method,
                           weight_by_samples=aggregator.weight_by_samples,
                           trim_frac=aggregator.trim_frac,
                           n_byzantine=aggregator.n_byzantine)
    raise TypeError(f"cannot derive an async merge rule from "
                    f"{type(aggregator).__name__}")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Buffered:
    """One completed-but-unmerged client contribution."""
    cid: int
    v0: int             # server version (flush count) at dispatch
    budget: int         # raw coreset budget b (>= m means full-set)
    k: int              # quantized group budget (0 = full-set)
    m: int              # client dataset size
    work: float         # samples visited (analytic)
    duration: float     # realized virtual training time
    staleness: int      # version - v0 at arrival (== at merge)
    dispatch_ix: int = 0    # per-client dispatch ordinal (fault stream key)


def run_async_fleet(model, clients_data: Sequence[ClientData],
                    specs: Sequence[ClientSpec], cfg: AsyncFleetConfig,
                    aggregator=None, scheduler=None,
                    test_data: Optional[Dict] = None, init_params=None,
                    engine: str = "batched", eval_batch: int = 512,
                    engine_obj: Optional[FleetEngine] = None, faults=None,
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_every: int = 0, resume: bool = False,
                    verbose: bool = False,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Drive the fleet's group programs through the async event loop.

    ``engine`` is ``"batched"`` (vmapped cohort groups, one dispatch a
    group), ``"loop"`` (the per-client reference: the same arithmetic,
    one step call per mini-batch) or ``"sharded"`` (each group's clients
    split across the ranks of the default process group, every rank
    running this same event loop, and each group's coefficient-weighted
    parameter sum arriving all-reduced; without a process group of more
    than one rank it runs batched, and ``engine_mode`` says so).
    ``engine_obj`` is a caller-built ``FleetEngine`` (a
    ``ShardedFleetEngine`` for a sharded run) whose config and device the
    run then uses (a warm engine across runs).  ``device=None`` means the
    CUDA card (on a sharded run ``cuda:<LOCAL_RANK>``); pass
    ``device="cpu"`` to run on the CPU.  ``init_params`` (a flat dict)
    defaults to ``model.init`` from a ``torch.Generator`` seeded with
    ``cfg.seed``.

    ``faults`` injects seeded failures (``repro_torch.fed.fleet.faults``):
    dropout kills a completion after its DISPATCH was accounted (the
    dispatch-trace cursor still advances, so surviving clients'
    capability and jitter draws are unchanged), churn masks the dispatch
    wave, and Byzantine corruption rewrites a fixed client subset's
    updates against their dispatch snapshot before the merge.

    Returns the ``run_federated_async`` result shape (params, history,
    event_log, telemetry) plus fleet accounting (group dispatch counts,
    buffer occupancy).

    ``checkpoint_dir`` + ``checkpoint_every`` snapshot the whole event
    loop every N applied flushes (``save_checkpoint``); ``resume=True``
    restores the latest snapshot, its tensors on this run's device, and
    continues byte for byte as the uninterrupted run: the same params,
    history and event log.  On a sharded run rank 0 alone writes the
    checkpoints and the recorder's sinks, and every rank reads the
    checkpoint after a barrier."""
    call = dict(locals())
    if engine not in ("batched", "loop", "sharded"):
        raise ValueError(f"unknown async fleet engine {engine!r} "
                         f"(expected batched | loop | sharded)")
    wall0 = _time.perf_counter()
    n = len(specs)
    if n == 0:
        raise ValueError("run_async_fleet needs at least one client")
    mode = engine
    if engine == "sharded":
        from repro_torch.fed.fleet.sharded import (ShardedFleetEngine,
                                                   rank_device, world_size)
        if world_size() == 1:   # one rank: sharding is pure overhead
            mode = "batched"
        elif dist.get_rank() != 0 and get_recorder().enabled:
            with use_recorder(NULL_RECORDER):   # rank 0 alone records
                return run_async_fleet(**call)
        elif (engine_obj is not None
              and not isinstance(engine_obj, ShardedFleetEngine)):
            raise ValueError("a sharded run needs a ShardedFleetEngine as "
                             "engine_obj")
    if engine_obj is not None:
        eng = engine_obj
        if device is not None and resolve_device(device) != eng.device:
            raise ValueError(f"run_async_fleet on {device} but engine_obj "
                             f"runs on {eng.device}")
        dev = eng.device
    elif mode == "sharded":
        dev = rank_device(device)
        eng = ShardedFleetEngine(model, cfg.fleet_config(), device=dev)
    else:
        dev = resolve_device(device)
        eng = FleetEngine(model, cfg.fleet_config(), device=dev)
    lead = mode != "sharded" or eng.rank == 0
    n_devices = eng.n_devices if mode == "sharded" else 1
    fcfg = eng.cfg
    rule = as_merge_rule(aggregator)
    rng = np.random.default_rng(cfg.seed)
    if init_params is None:
        init_params = model.init(torch.Generator().manual_seed(cfg.seed), dev)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in init_params.items()}
    cost = resolve_cost(cfg.cost)
    deadline = cfg.deadline
    if deadline is None:
        deadline = straggler_deadline(specs, cfg.epochs, cfg.straggler_pct,
                                      cost)
    trace = CapabilityTrace(cfg.trace) if cfg.trace is not None else None
    eval_fn = (make_eval_fn(model, test_data, eval_batch, device=dev)
               if test_data else None)
    ftrace, fault_name = make_fault_trace(faults, n, cfg.seed)
    corruption = ftrace is not None and ftrace.profile.has_corruption
    layouts = getattr(model, "reference_layouts", None)

    # a buffer larger than the in-flight cap could never fill; clamp both
    # to the fleet size so tiny fleets still make progress
    concurrency = min(cfg.concurrency, n)
    buffer_k = max(1, min(cfg.buffer_k, concurrency))

    sizes = np.array([s.m for s in specs], np.float64)
    busy = np.zeros(n, bool)
    busy_time = np.zeros(n)
    tracei = DispatchTraceIndexer(n, trace)
    obs = active_recorder(verbose and lead)
    obs.run_meta(runtime="async_fleet", engine=mode,
                 requested_engine=engine, aggregator=rule.name,
                 faults=fault_name, n_clients=n,
                 max_updates=cfg.max_updates,
                 buffer_k=buffer_k, concurrency=concurrency,
                 deadline=float(deadline), seed=cfg.seed,
                 n_devices=n_devices, device=str(dev))

    queue = EventQueue()
    event_log: List[str] = []
    history: List[RoundRecord] = []
    staleness_log: List[int] = []
    occupancy_log: List[int] = []

    buffer: List[_Buffered] = []
    # dispatch-time params, pinned until every client trained from a
    # version has been merged: version -> [params, refcount]
    params_by_version: Dict[int, List[Any]] = {}
    pending: Dict[int, _Buffered] = {}   # cid -> in-flight contribution

    version = 0
    applied = 0
    now = 0.0
    merged_total = 0
    violations_total = 0
    partial_flushes = 0
    dropped_total = 0       # fault-dropped completions (update lost)
    corrupted_total = 0     # Byzantine-rewritten lanes merged
    rec_dropped = 0         # drops inside the current flush window
    rec_start = 0.0
    rec_wall0 = _time.perf_counter()
    # as in repro_torch.fed.events, the "round" is a flush-to-flush record
    # window, so the round and buffer_fill spans open and close at window
    # boundaries rather than around a lexical block
    round_span = None
    fill_span = None

    def dispatch_wave(t: float) -> int:
        """Refill free slots with one weighted no-replacement draw.

        Waves run only at t=0 and after a flush (never per completion),
        so a client holds at most one spot per buffer and the wave is
        one ``rng.choice`` whatever the fleet size.  Under churn, the
        present-mask at the current server version zeroes absent
        clients' sampling weight: the sync fleet's cohort filter,
        indexed by flush instead of round."""
        free = concurrency - int(busy.sum())
        if free <= 0:
            return 0
        p = sizes * ~busy
        if scheduler is not None:
            p = p * scheduler.eligible_mask()
        if ftrace is not None and ftrace.profile.has_churn:
            mask, joins, leaves = ftrace.churn_step(version)
            p = p * mask
            obs.metrics.counter("faults.churn_joins").inc(joins)
            obs.metrics.counter("faults.churn_leaves").inc(leaves)
            obs.metrics.gauge("faults.n_present").set(int(mask.sum()))
        total = p.sum()
        if total <= 0.0:
            return 0
        s = min(free, int((p > 0).sum()))
        picks = rng.choice(n, size=s, replace=False, p=p / total)
        for cid in np.sort(picks):
            busy[cid] = True
            queue.push(t, DISPATCH, int(cid), version)
        slot = params_by_version.setdefault(version, [params, 0])
        slot[1] += s
        return s

    def merge_buffer(t: float, partial: bool) -> None:
        """Flush: micro-batch the buffer into cohort groups, run each
        group from its dispatch snapshot, and merge through the rule.
        ``partial=True`` marks a final drain of an under-filled buffer
        (tail updates are merged, not dropped)."""
        nonlocal params, version, applied, merged_total, violations_total
        nonlocal partial_flushes, corrupted_total, rec_dropped
        nonlocal rec_start, rec_wall0, round_span, fill_span
        obs.span_end(fill_span)
        buf, buffer[:] = list(buffer), []
        stal = np.array([e.staleness for e in buf], np.int64)
        msz = np.array([e.m for e in buf], np.int64)
        c, c_w = rule.coefficients(stal, msz)
        coef = {e.cid: float(ci) for e, ci in zip(buf, c)}
        # robust rules and Byzantine corruption need the per-client
        # parameter stacks; the linear rules only the weighted sums
        use_stack = rule.robust or corruption
        dix = {e.cid: e.dispatch_ix for e in buf}
        msz_by_cid = {e.cid: e.m for e in buf}

        # group by dispatch snapshot, then by (M, k) shape within it:
        # every client trains from the params it was handed
        by_v0: Dict[int, List[_Buffered]] = {}
        for e in buf:
            by_v0.setdefault(e.v0, []).append(e)
        with obs.span("cohort_build", n_clients=len(buf),
                      n_versions=len(by_v0)):
            grouped = []
            for v0 in sorted(by_v0):
                entries = by_v0[v0]
                groups = make_cohort_groups(
                    clients_data, [e.cid for e in entries],
                    {e.cid: e.budget for e in entries}, fcfg,
                    round_seed=len(history))
                grouped.append((v0, groups))

        # one group program per group; each adds its coefficient-weighted
        # parameter sum (one tensordot a leaf, all-reduced on the sharded
        # mesh), no host-side client loop
        acc = None
        stack_parts = []        # (per-client stack, cids): robust path
        n_corrupted = 0
        losses_by_cid: Dict[int, float] = {}
        loss_parts = []
        with obs.span("dispatch", n_clients=len(buf),
                      n_groups=sum(len(gs) for _, gs in grouped)):
            for v0, groups in grouped:
                base = params_by_version[v0][0]
                for g in groups:
                    w = np.array([coef[int(cid)] for cid in g.cids],
                                 np.float64)
                    part = None
                    if mode == "sharded":
                        part, _, losses, _, p = eng.run_group_sharded(
                            base, g, w, gather_stack=use_stack)
                    else:
                        p, losses, _ = eng.run_group(
                            params=base, group=g,
                            batched=(mode == "batched"))
                    if use_stack:
                        if corruption:
                            ords = np.array(
                                [dix[int(cid)] for cid in g.cids], np.int64)
                            p, nc = corrupt_stacked(p, base, g.cids, ords,
                                                    ftrace, layouts)
                            n_corrupted += nc
                        if rule.robust:
                            part = None
                            stack_parts.append((p, np.asarray(g.cids)))
                        else:       # linear rule over corrupted lanes
                            part = weighted_param_sum(p, w)
                    elif part is None:
                        part = weighted_param_sum(p, w)
                    if part is not None:
                        acc = part if acc is None else tree_add(acc, part)
                    loss_parts.append((g.cids, losses))
        with obs.span("aggregate", n_clients=len(buf), n_versions=len(by_v0),
                      partial=partial):
            if rule.robust:
                # concatenate the group stacks (deterministic group order)
                # and hand the whole flush to the estimator
                stacks = [s for s, _ in stack_parts]
                stacked = (stacks[0] if len(stacks) == 1 else
                           {k: torch.cat([s[k] for s in stacks])
                            for k in stacks[0]})
                order = np.concatenate([cids for _, cids in stack_parts])
                wts = (np.array([msz_by_cid[int(i)] for i in order],
                                np.float64)
                       if rule.weight_by_samples else None)
                combined = robust_combine(
                    stacked, rule.method, weights=wts, base=params,
                    trim_frac=rule.trim_frac, n_byzantine=rule.n_byzantine,
                    layouts=layouts)
                lr = rule.server_lr
                new = (combined if lr >= 1.0 else
                       tree_add(tree_scale(params, 1.0 - lr),
                                tree_scale(combined, lr)))
            elif rule.use_base:   # w + sum c_i w_i - sum_v (sum_i c_i) base_v
                new = tree_add(params, acc)
                for v0, _ in grouped:
                    bsum = float(sum(coef[e.cid] for e in by_v0[v0]))
                    new = tree_add(new, tree_scale(
                        params_by_version[v0][0], -bsum))
            elif c_w == 0.0:
                new = acc
            else:
                new = tree_add(tree_scale(params, c_w), acc)
            params = new
            if dev.type == "cuda":  # the span ends with the merge's work
                torch.cuda.synchronize(dev)
        corrupted_total += n_corrupted
        if n_corrupted:
            obs.metrics.counter("faults.corrupted_updates").inc(n_corrupted)
        with obs.span("gather", n_clients=len(buf)):
            # the groups' losses, already on the host (run_group reads
            # them back inside its span, which so holds the device work)
            for cids, losses in loss_parts:
                for cid, ls in zip(cids, np.asarray(losses)):
                    losses_by_cid[int(cid)] = float(ls)

        # unpin dispatch snapshots: decrement every merged ref first,
        # then prune, so duplicate v0s in one flush can't double-free
        for e in buf:
            params_by_version[e.v0][1] -= 1
        for v in [v for v, slot in params_by_version.items()
                  if slot[1] <= 0]:
            del params_by_version[v]

        version += 1
        applied += 1
        merged_total += len(buf)
        if partial:
            partial_flushes += 1
            obs.metrics.counter("aggregator.partial_flushes").inc()
        n_viol = sum(e.duration > deadline * (1.0 + 1e-9) for e in buf)
        violations_total += n_viol
        obs.metrics.counter("deadline_violations").inc(n_viol)
        train_loss = (float(np.mean([losses_by_cid[e.cid] for e in buf]))
                      if buf else float("nan"))
        if scheduler is not None:
            scheduler.record_round(train_loss)
        rec = RoundRecord(
            round=len(history), sim_round_time=t - rec_start,
            client_times=[float(e.duration) for e in buf],
            n_participants=len(buf), n_dropped=rec_dropped,
            n_coreset=sum(e.k > 0 for e in buf),
            train_loss=train_loss, n_violations=n_viol)
        if eval_fn and (len(history) % cfg.eval_every == 0
                        or applied >= cfg.max_updates or partial):
            with obs.span("eval", round=rec.round):
                rec.test_acc, rec.test_loss = eval_fn(params)
        history.append(rec)
        obs.span_end(round_span)
        obs.event("round", runtime="async_fleet", engine=mode,
                  label=f"async_fleet/{rule.name}", round=rec.round,
                  n_participants=rec.n_participants, n_dropped=rec_dropped,
                  n_corrupted=n_corrupted,
                  n_coreset=rec.n_coreset, n_violations=n_viol,
                  sim_round_time=float(rec.sim_round_time),
                  wall_time_s=_time.perf_counter() - rec_wall0,
                  train_loss=float(rec.train_loss),
                  test_acc=float(rec.test_acc),
                  test_loss=float(rec.test_loss),
                  applied=applied, t_virtual=float(t),
                  buffered=len(buf), partial=partial,
                  mean_staleness=float(stal.mean()) if len(buf) else 0.0)
        obs.event("clients", round=rec.round,
                  cids=[int(e.cid) for e in buf],
                  durations=[float(e.duration) for e in buf],
                  violated=[bool(e.duration > deadline * (1.0 + 1e-9))
                            for e in buf])
        rec_start = t
        rec_wall0 = _time.perf_counter()
        rec_dropped = 0
        # snapshot *between* windows: the flush is fully accounted and
        # the continuation wave has not fired yet, so a resumed run
        # replays the wave and the next window byte for byte
        if (checkpoint_dir is not None and checkpoint_every > 0
                and not partial and applied % checkpoint_every == 0
                and lead):
            save_checkpoint(t)
        if applied < cfg.max_updates and not partial:
            # the run continues: open the next flush window
            round_span = obs.span_begin("round", round=len(history))
            with obs.span("dispatch_wave", round=len(history)):
                dispatch_wave(t)
            fill_span = obs.span_begin("buffer_fill", round=len(history))
        else:
            # terminal flush: no trailing sliver of a window
            round_span = fill_span = None

    def save_checkpoint(t: float) -> None:
        """Snapshot the complete event-loop state.

        The params and every pinned dispatch snapshot go into one npz
        tree; the virtual clock (the queue's heap and push sequence),
        pending and buffered contributions, logs, counters, refcounts,
        dispatch cursors, the numpy RNG's bit-generator state and the
        scheduler's state go into the JSON meta.  Nothing of torch is in
        the meta: the clock's times and durations are Python floats."""
        with obs.span("checkpoint", round=len(history)):
            tree = {"params": params,
                    "versions": {str(v): slot[0]
                                 for v, slot in params_by_version.items()}}
            meta = {
                "kind": "async_fleet",
                "version": version, "applied": applied, "now": float(t),
                "merged_total": merged_total,
                "violations_total": violations_total,
                "partial_flushes": partial_flushes,
                "dropped_total": dropped_total,
                "corrupted_total": corrupted_total,
                "rec_start": float(rec_start),
                "seq": int(queue._seq),
                "heap": [[float(ht), int(hs), he.kind, int(he.cid),
                          int(he.version), float(he.duration)]
                         for ht, hs, he in queue._heap],
                "event_log": list(event_log),
                "history": [dataclasses.asdict(r) for r in history],
                "staleness_log": [int(x) for x in staleness_log],
                "occupancy_log": [int(x) for x in occupancy_log],
                "busy": busy.tolist(),
                "busy_time": busy_time.tolist(),
                "pending": {str(cid): dataclasses.asdict(e)
                            for cid, e in pending.items()},
                "buffer": [dataclasses.asdict(e) for e in buffer],
                "refcounts": {str(v): int(slot[1])
                              for v, slot in params_by_version.items()},
                "dispatch_counts": tracei.counts.tolist(),
                "rng_state": rng.bit_generator.state,
            }
            if scheduler is not None and hasattr(scheduler, "state_dict"):
                meta["scheduler"] = scheduler.state_dict()
            save_server_state(checkpoint_dir, applied, tree, extra=meta)

    if resume and checkpoint_dir is not None:
        if mode == "sharded":       # rank 0 may still be writing
            dist.barrier(group=eng.group)
        tree, _ = load_server_state(checkpoint_dir, device=dev)
        meta = load_server_meta(checkpoint_dir)
        if tree is not None and meta is not None \
                and meta.get("kind") == "async_fleet":
            params = tree["params"]
            refc = meta["refcounts"]
            params_by_version = {int(v): [pv, int(refc[v])]
                                 for v, pv in tree["versions"].items()}
            version = int(meta["version"])
            applied = int(meta["applied"])
            now = float(meta["now"])
            merged_total = int(meta["merged_total"])
            violations_total = int(meta["violations_total"])
            partial_flushes = int(meta["partial_flushes"])
            dropped_total = int(meta["dropped_total"])
            corrupted_total = int(meta["corrupted_total"])
            rec_start = float(meta["rec_start"])
            event_log[:] = [str(s) for s in meta["event_log"]]
            history[:] = [RoundRecord(**h) for h in meta["history"]]
            staleness_log[:] = [int(x) for x in meta["staleness_log"]]
            occupancy_log[:] = [int(x) for x in meta["occupancy_log"]]
            busy[:] = np.asarray(meta["busy"], bool)
            busy_time[:] = np.asarray(meta["busy_time"], np.float64)
            pending.clear()
            pending.update({int(k): _Buffered(**v)
                            for k, v in meta["pending"].items()})
            buffer[:] = [_Buffered(**v) for v in meta["buffer"]]
            # the saved heap list already holds the heap invariant
            queue._heap[:] = [
                (ht, hs, Event(ht, hs, kind, int(cid), int(ver), dur))
                for ht, hs, kind, cid, ver, dur in meta["heap"]]
            queue._seq = int(meta["seq"])
            tracei.counts[:] = np.asarray(meta["dispatch_counts"], np.int64)
            rng.bit_generator.state = meta["rng_state"]
            if (scheduler is not None and "scheduler" in meta
                    and hasattr(scheduler, "load_state_dict")):
                scheduler.load_state_dict(meta["scheduler"])
            obs.event("resume", runtime="async_fleet", round=len(history),
                      applied=applied, checkpoint_dir=str(checkpoint_dir))

    # open the first flush window.  On a fresh start this is round 0 at
    # t = 0; on resume it replays the continuation ``merge_buffer`` would
    # have run after the checkpointed flush (the same wave, the same RNG
    # draw, the same event sequence numbers)
    round_span = obs.span_begin("round", round=len(history))
    with obs.span("dispatch_wave", round=len(history)):
        dispatch_wave(now)
    fill_span = obs.span_begin("buffer_fill", round=len(history))
    unprocessed = []    # events past a max_virtual_time cutoff

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
            k_idx = tracei.begin(ev.cid)
            c_eff = tracei.capability(spec, k_idx)
            obs.metrics.counter("dispatches").inc()
            # budget under *realized* capability: a device in a slowdown
            # episode plans a smaller coreset, as the sync FedCore client
            # would at dispatch time; the cost model prices each
            # sample-visit (legacy unit cost when unset)
            if scheduler is not None:
                b = int(scheduler.budget(ev.cid, deadline, cfg.epochs))
            elif cost.needs_coreset(spec.m, c_eff, deadline, cfg.epochs):
                b = cost.budget(spec.m, c_eff, deadline, cfg.epochs)
            else:
                b = spec.m
            kq = 0 if b >= spec.m else _floor_pow4(b)
            work = float(cfg.epochs * spec.m if kq == 0
                         else spec.m + (cfg.epochs - 1) * kq)
            duration = cost.duration(work, c_eff) * tracei.jitter(spec,
                                                                  k_idx)
            pending[ev.cid] = _Buffered(
                cid=ev.cid, v0=ev.version, budget=b, k=kq, m=spec.m,
                work=work, duration=duration, staleness=0,
                dispatch_ix=k_idx)
            queue.push(now + duration, COMPLETE, ev.cid, ev.version,
                       duration)
            continue

        # COMPLETE: buffer the contribution; train only at flush time
        e = pending.pop(ev.cid)
        busy[ev.cid] = False
        busy_time[ev.cid] += ev.duration
        obs.metrics.histogram("client_busy_s").observe(ev.duration)
        if scheduler is not None:
            scheduler.observe(ev.cid, float(cost.work_units(e.work)),
                              ev.duration)
        if ftrace is not None and ftrace.dropped(ev.cid, e.dispatch_ix):
            # mid-round dropout: the client trained, but its update is
            # lost in flight.  Its dispatch was already accounted (trace
            # cursor, busy time, capability EWMA), so surviving clients'
            # draws are those of the fault-free run; only the merge never
            # sees this one
            rec_dropped += 1
            dropped_total += 1
            obs.metrics.counter("faults.dropped_updates").inc()
            params_by_version[e.v0][1] -= 1     # ref will never merge
            if params_by_version[e.v0][1] <= 0:
                del params_by_version[e.v0]
            continue
        e.staleness = version - e.v0
        staleness_log.append(e.staleness)
        obs.metrics.histogram("staleness", exact=True).observe(e.staleness)
        buffer.append(e)
        occupancy_log.append(len(buffer))
        obs.metrics.histogram("buffer_occupancy",
                              exact=True).observe(len(buffer))
        if len(buffer) >= buffer_k:
            merge_buffer(now, partial=False)

    # final drain: an under-filled buffer at termination holds real client
    # work; merge it (counted as a partial flush) instead of dropping the
    # tail, as Aggregator.flush does in the event runtime
    if buffer and applied < cfg.max_updates:
        merge_buffer(now, partial=True)
    if fill_span is not None:
        obs.span_end(fill_span)
    if round_span is not None:
        obs.span_end(round_span)    # the trailing cutoff window, if open

    makespan = now
    # credit clients still mid-training at termination for busy time
    # accrued inside [0, makespan] (their COMPLETE never processed)
    for ev in unprocessed + queue.events():
        if ev.kind == COMPLETE and ev.cid in pending:
            busy_time[ev.cid] += max(0.0, ev.duration - (ev.time - makespan))
    active = tracei.counts > 0
    shist = (np.bincount(staleness_log) if staleness_log
             else np.zeros(1, np.int64))
    ohist = (np.bincount(occupancy_log) if occupancy_log
             else np.zeros(1, np.int64))
    telemetry = {
        "makespan": float(makespan),
        "client_utilization": float(busy_time.sum()
                                    / max(n * makespan, 1e-12)),
        "active_client_utilization": float(
            busy_time[active].sum()
            / max(active.sum() * makespan, 1e-12)) if active.any() else 0.0,
        "staleness_hist": shist,
        "mean_staleness": (float(np.mean(staleness_log))
                           if staleness_log else 0.0),
        "max_staleness": int(shist.size - 1),
        "buffer_occupancy_hist": ohist,
        "mean_buffer_occupancy": (float(np.mean(occupancy_log))
                                  if occupancy_log else 0.0),
        "n_dispatches": int(tracei.counts.sum()),
        "n_group_dispatches": int(eng.dispatch_count),
        "n_updates_applied": applied,
        "n_merged_clients": merged_total,
        "n_partial_flushes": partial_flushes,
        "n_violations": violations_total,
        "n_dropped_updates": dropped_total,
        "n_corrupted_updates": corrupted_total,
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
        obs.metrics.gauge("mean_buffer_occupancy").set(
            telemetry["mean_buffer_occupancy"])
    return {
        "params": params,
        "history": history,
        "deadline": deadline,
        "engine": engine,           # requested
        "engine_mode": mode,        # executed
        "aggregator": rule.name,
        "faults": fault_name,
        "version": version,
        "applied": applied,
        "event_log": event_log,
        "telemetry": telemetry,
        "n_devices": n_devices,
        "strategy": "fedcore_async_fleet",
    }
