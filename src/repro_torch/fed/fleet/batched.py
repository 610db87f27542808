"""Batched fleet client engine: cohort rounds without a per-client loop.

The synchronous server (``repro_torch.fed.server``) runs clients one at
a time.  This module runs a whole cohort as a handful of batched passes:

  * clients are padded into **cohort groups** keyed by (padded size M,
    quantized coreset budget k): every client of a group shares its
    shapes, so local SGD runs ``torch.func.vmap`` over the client axis
    (``functional_call`` through the model, ``torch.func.grad`` for the
    step), and the group's coresets come from one masked k-medoids solve
    (``repro_torch.core.coreset.build_coreset_batched``: the batched
    pairwise kernel below the ``materialize_below`` cutover, the
    distance-free kernels at or above it);
  * per-client randomness (epoch permutations) is drawn host-side from
    ``(seed, round, cid)`` streams, so results are a pure function of the
    seed whatever the grouping or execution order;
  * the same arithmetic runs either vmapped (``engine="batched"``) or as
    a per-client Python loop (``engine="loop"``): one client at a time,
    one step call per mini-batch — the execution model the batched
    engine replaces.  Both paths call the same per-client step, so they
    agree to float32 tolerance.

Local-training semantics (simpler than ``repro_torch.fed.strategies`` so
they batch): each epoch visits all M padded slots in a seeded per-client
permutation, B at a time; padded samples carry zero loss weight.
Straggling clients run Alg. 1: gradient features at the round-start
params, k-medoids coreset selection, one full-set epoch, then E−1
weighted full-batch epochs on the coreset.

The JAX package compiles each group into one jitted program with donated
buffers; PyTorch runs eagerly and has no counterpart of either, so
``dispatch_count`` counts one dispatch per group (one per step on the
loop path) as the reference does, and its program-cache counters have no
counterpart here.  Not ported yet, each raising ``NotImplementedError``:
robust ``aggregator`` values and every ``faults`` profile but
``"none"`` (ROADMAP item 12),
``checkpoint_dir`` / ``resume`` (item 13) and ``engine="sharded"``
(item 15).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.coreset import build_coreset_batched
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.cost import resolve_cost
from repro_torch.fed.faults import check_no_faults
from repro_torch.fed.fleet.workloads import client_num_samples
from repro_torch.fed.server import RoundRecord, make_eval_fn
from repro_torch.fed.simulator import (CapabilityTrace, ClientSpec,
                                       DispatchTraceIndexer, TraceConfig,
                                       straggler_deadline)
from repro_torch.obs import active_recorder, get_recorder

Params = Dict[str, torch.Tensor]
ClientData = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    epochs: int = 2               # E
    batch_size: int = 32          # B
    lr: float = 0.05
    # tri-state kernel switch for selection (distance stacks + BUILD /
    # Δ-sweep reductions): None = CUDA kernels for tensors on the card,
    # plain PyTorch on the CPU; False on the card is the A/B
    use_kernel: Optional[bool] = None
    # distance-free selection: at M >= materialize_below the k-medoids
    # reductions consume the (C, M, F) feature stack and hold the (C, M, M)
    # distances only in each call's bounded workspace; below the cutover
    # (and with distance_free=False) selection materializes the stack
    distance_free: bool = True
    materialize_below: int = 256
    max_sweeps: int = 25          # k-medoids swap sweeps
    weight_by_samples: bool = True  # aggregate ∝ mⁱ
    seed: int = 0
    # per-sample step cost (repro_torch.fed.cost.WorkloadCostModel or
    # scalar; None = legacy samples-cost-1.0)
    cost: Any = None
    # server combine rule; only "weighted_mean" is ported (robust rules:
    # ROADMAP item 12)
    aggregator: str = "weighted_mean"


@dataclasses.dataclass
class CohortGroup:
    """A same-shape slice of a cohort: C clients padded to M samples.

    Arrays stay host-side (numpy): the batched engine moves each group to
    the device as one stack, the loop reference one client's slice at a
    time.  ``data`` maps each schema field to a stacked (C, M, ...)
    array."""
    cids: np.ndarray              # (C,) global client ids
    data: ClientData              # stacked (C, M, ...) padded client data
    valid: np.ndarray             # (C, M) bool — real-sample mask
    m: np.ndarray                 # (C,) true sizes
    k: int                        # coreset budget (0 = full-set training)
    perms: np.ndarray             # (C, E, M) per-epoch sample permutations

    @property
    def n_clients(self) -> int:
        return len(self.cids)


@dataclasses.dataclass
class FleetRoundStats:
    """Per-client outcome of one fleet round, in cohort order."""
    cids: np.ndarray              # (N,)
    m: np.ndarray                 # (N,)
    budgets: np.ndarray           # (N,) effective budget (m if full-set)
    used_coreset: np.ndarray      # (N,) bool
    work: np.ndarray              # (N,) work units (samples visited)
    losses: np.ndarray            # (N,) final local train loss
    medoids: Dict[int, np.ndarray]  # cid -> (k,) selected sample indices


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _floor_pow4(n: int) -> int:
    """Largest power of 4 ≤ n — the coreset-budget quantizer.

    Rounding budgets down can never violate a deadline (any k ≤ bⁱ is
    deadline-safe); the coarse ×4 ladder keeps the number of distinct
    (M, k) cohort groups small at fleet scale."""
    return 1 << (((max(int(n), 1).bit_length() - 1) // 2) * 2)


def _pad_rows(v: np.ndarray, m_pad: int) -> np.ndarray:
    """Pad axis 0 to ``m_pad`` by repeating the last row (finite values
    that keep feature scales sane; padded rows are masked everywhere)."""
    m = v.shape[0]
    if m == m_pad:
        return v
    return np.concatenate([v, np.repeat(v[-1:], m_pad - m, axis=0)])


def nominal_budgets(specs: Sequence[ClientSpec], deadline: float,
                    epochs: int, cost=None) -> Dict[int, int]:
    """Paper §4.2 budgets from nominal capabilities: bⁱ for clients that
    need a coreset under (τ, E), mⁱ (full set) for the rest."""
    cm = resolve_cost(cost)
    return {s.cid: (cm.budget(s.m, s.c, deadline, epochs)
                    if cm.needs_coreset(s.m, s.c, deadline, epochs)
                    else s.m)
            for s in specs}


def make_cohort_groups(clients_data: Sequence[ClientData],
                       cids: Sequence[int], budgets: Dict[int, int],
                       cfg: FleetConfig, round_seed: int = 0
                       ) -> List[CohortGroup]:
    """Bucket a cohort into same-shape groups.

    ``budgets[cid] >= m`` means full-set training.  Padded size M is the
    next power-of-two number of batches; coreset budgets are quantized
    down to a power of four (``_floor_pow4``) so a group shares one k
    that exceeds no member's deadline budget.  Per-client epoch
    permutations are drawn from ``(cfg.seed, round_seed, cid)`` streams:
    the grouping cannot change any client's arithmetic.  A caller-given
    ``weights`` field is dropped (loss weights come from the padding
    mask).
    """
    by_key: Dict[Tuple[int, int], List[int]] = {}
    for cid in cids:
        m = client_num_samples(clients_data[cid])
        m_pad = _next_pow2(-(-m // cfg.batch_size)) * cfg.batch_size
        b = int(budgets[cid])
        k = 0 if b >= m else _floor_pow4(b)
        by_key.setdefault((m_pad, k), []).append(cid)

    groups = []
    for (m_pad, k), members in sorted(by_key.items()):
        fields = [f for f in clients_data[members[0]] if f != "weights"]
        stacked = {f: np.stack([_pad_rows(np.asarray(clients_data[cid][f]),
                                          m_pad) for cid in members])
                   for f in fields}
        ms = np.array([client_num_samples(clients_data[cid])
                       for cid in members])
        valid = np.arange(m_pad)[None, :] < ms[:, None]
        base = np.tile(np.arange(m_pad), (cfg.epochs, 1))
        perms = np.stack([
            np.random.default_rng(
                np.random.SeedSequence((cfg.seed, round_seed, cid))
            ).permuted(base, axis=1)
            for cid in members]).astype(np.int32)
        groups.append(CohortGroup(
            cids=np.array(members), data=stacked,
            valid=valid, m=ms, k=k, perms=perms))
    return groups


class FleetEngine:
    """Runs cohort groups on one device, batched or one client at a time.

    ``run_group(..., batched=True)`` runs all C clients of a group
    together: every SGD step is one ``vmap`` over the client axis of the
    per-client step, and the straggler path (gradient features →
    batched coreset selection → one full-set epoch → E−1 coreset epochs)
    selects all C coresets in one solve.  ``batched=False`` is the
    per-client Python loop: the same per-client step, feature pass and
    masked k-medoids solve, one client at a time with one step call per
    mini-batch.  Only the batching differs, so results match.

    ``dispatch_count`` counts dispatches through ``count_dispatch``, as
    the JAX package does: one per group on the batched path, one per step
    (and per feature pass) on the loop path.
    """

    def __init__(self, model, cfg: FleetConfig, device: DeviceLike = None):
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dispatch_count = 0
        self._vm_sgd_step = vmap(self._sgd_step)
        self._vm_core_step = vmap(self._core_step)

    def count_dispatch(self, n: int = 1) -> None:
        """The dispatch accounting point of every execution mode."""
        self.dispatch_count += n
        get_recorder().metrics.counter("fleet.dispatches").inc(n)

    # -- one client's arithmetic (vmapped over the client axis when
    #    batched) ----------------------------------------------------------

    def _step(self, p: Params, batch: Dict[str, torch.Tensor]):
        grads, loss = grad_and_value(
            lambda q: self.model.loss(q, batch)[0])(p)
        lr = self.cfg.lr
        return {k: p[k] - lr * grads[k] for k in p}, loss

    def _sgd_step(self, p, data, w, ix):
        """One mini-batch SGD step for one client."""
        batch = {k: v[ix] for k, v in data.items()}
        batch["weights"] = w[ix]
        return self._step(p, batch)

    def _core_step(self, p, cdata, cw):
        """One weighted full-batch epoch on one client's coreset."""
        return self._step(p, dict(cdata, weights=cw))

    def _features(self, params: Params, data: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
        """One client's (M, F) gradient features.  Both execution modes
        run this per client: under ``vmap`` the client axis folds into the
        batch of the convolution and matrix product, whose library kernels
        may then sum in another order, and a near-tie in k-medoids turns
        that last bit into another, equally good coreset."""
        with torch.no_grad():
            return self.model.grad_features(params, data).float()

    def _select(self, feats, valid, k):
        cfg = self.cfg
        return build_coreset_batched(
            feats, valid, k, use_kernel=cfg.use_kernel,
            max_sweeps=cfg.max_sweeps, distance_free=cfg.distance_free,
            materialize_below=cfg.materialize_below)

    # -- group execution --------------------------------------------------

    def _to_device(self, v: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(v, device=self.device)

    def _batch_indices(self, group: CohortGroup, epochs: slice
                       ) -> torch.Tensor:
        """(C, T, B) mini-batch index tensor for the given epochs."""
        sel = group.perms[:, epochs]                       # (C, e, M)
        c, e, m_pad = sel.shape
        b = self.cfg.batch_size
        return self._to_device(sel.reshape(c, e * (m_pad // b), b)
                               .astype(np.int64))

    def _vm_sgd(self, p, data, w, idx):
        loss = None
        for t in range(idx.shape[1]):
            p, loss = self._vm_sgd_step(p, data, w, idx[:, t])
        return p, loss

    def _run_group_stacked(self, params: Params, group: CohortGroup):
        """All clients of a group at once; returns (params (C, ...),
        losses (C,), medoid indices (C, k) or None).  The losses and
        medoids come back to the host inside the group's span, so the
        span ends when the group's work on the device does."""
        cfg = self.cfg
        obs = get_recorder()
        c = group.n_clients
        self.count_dispatch()
        name = "local_sgd" if group.k == 0 else "coreset_group"
        with obs.span(name, k=group.k, n_clients=c):
            data = {f: self._to_device(v) for f, v in group.data.items()}
            w = self._to_device(group.valid.astype(np.float32))   # (C, M)
            p0 = {k: v.expand((c,) + v.shape) for k, v in params.items()}
            if group.k == 0:     # full set: E epochs of mini-batch SGD
                p, losses = self._vm_sgd(p0, data, w, self._batch_indices(
                    group, slice(None)))
                return p, losses.cpu().numpy(), None
            # Alg. 1 straggler path: features at the round-start params,
            # batched coreset selection, one full-set epoch, E−1 coreset
            # epochs
            with obs.span("grad_features", k=group.k, n_clients=c):
                feats = torch.stack([
                    self._features(params,
                                   {f: v[i] for f, v in data.items()})
                    for i in range(c)])                           # (C, M, F)
            with obs.span("selection", k=group.k, n_clients=c):
                coreset = self._select(feats, self._to_device(group.valid),
                                       group.k)
            p, _ = self._vm_sgd(p0, data, w,
                                self._batch_indices(group, slice(0, 1)))
            rows = torch.arange(c, device=self.device)[:, None]
            ix = coreset.indices.long()
            cdata = {f: v[rows, ix] for f, v in data.items()}   # (C, k, ...)
            for _ in range(max(cfg.epochs - 1, 1)):
                p, losses = self._vm_core_step(p, cdata, coreset.weights)
            return p, losses.cpu().numpy(), coreset.indices.cpu().numpy()

    def _run_client_loop(self, params: Params, group: CohortGroup, i: int
                         ) -> Tuple[Params, float, Optional[np.ndarray]]:
        """One client of a group, one step call per mini-batch."""
        cfg = self.cfg
        data = {f: self._to_device(v[i]) for f, v in group.data.items()}
        w = self._to_device(group.valid[i].astype(np.float32))
        m_pad = group.valid.shape[1]
        idx = self._to_device(group.perms[i].reshape(
            cfg.epochs, m_pad // cfg.batch_size, cfg.batch_size)
            .astype(np.int64))

        def run_epoch(p, e):
            loss = 0.0
            for t in range(idx.shape[1]):
                p, loss = self._sgd_step(p, data, w, idx[e, t])
            self.count_dispatch(idx.shape[1])    # one step call per batch
            return p, loss

        if group.k == 0:
            p, loss = params, 0.0
            for e in range(cfg.epochs):
                p, loss = run_epoch(p, e)
            return p, float(loss), None

        with get_recorder().span("grad_features", k=group.k, n_clients=1):
            feats = self._features(params, data)
        self.count_dispatch()
        coreset = self._select(feats[None],
                               self._to_device(group.valid[i:i + 1]),
                               group.k)
        p, _ = run_epoch(params, 0)
        med = coreset.indices[0]
        cdata = {f: v[med.long()] for f, v in data.items()}
        loss = 0.0
        for _ in range(max(cfg.epochs - 1, 1)):
            p, loss = self._core_step(p, cdata, coreset.weights[0])
        self.count_dispatch(max(cfg.epochs - 1, 1))
        return p, float(loss), med.cpu().numpy()

    def run_group(self, params: Params, group: CohortGroup,
                  batched: bool = True
                  ) -> Tuple[Params, np.ndarray, Optional[np.ndarray]]:
        """Run one group; returns (stacked client params (C, ...), losses
        (C,), medoid indices (C, k) or None)."""
        if batched:
            return self._run_group_stacked(params, group)
        ps, losses, meds = [], [], []
        name = "local_sgd" if group.k == 0 else "coreset_group"
        with get_recorder().span(name, k=group.k,
                                 n_clients=group.n_clients, mode="loop"):
            for i in range(group.n_clients):
                p, loss, med = self._run_client_loop(params, group, i)
                ps.append(p)
                losses.append(loss)
                if med is not None:
                    meds.append(med)
        stacked = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
        return (stacked, np.array(losses),
                np.stack(meds) if meds else None)


def weighted_param_sum(stacked: Params, weights) -> Params:
    """Σ_c w_c · p_c over a (C, ...) parameter stack: one tensordot per
    leaf, no per-client loop."""
    first = next(iter(stacked.values()))
    ws = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                         device=first.device)
    return {k: torch.tensordot(ws, x.float(), dims=([0], [0]))
            for k, x in stacked.items()}


def _aggregate_groups(partials: List[Tuple[Params, np.ndarray]],
                      fallback: Params) -> Params:
    """Weighted mean over all cohort clients: Σ_g Σ_c w·p / Σ w.

    Group-partial sums keep the reduction order independent of the
    engine.  An empty cohort, or one whose weights sum to zero, returns
    ``fallback`` (the round-start params) unchanged."""
    total = sum(float(w.sum()) for _, w in partials)
    if not partials or total <= 0.0:
        return fallback
    acc = None
    for stacked, w in partials:
        part = weighted_param_sum(stacked, w)
        acc = part if acc is None else {k: acc[k] + part[k] for k in acc}
    return {k: v / total for k, v in acc.items()}


def _cat(parts: List[np.ndarray], dtype) -> np.ndarray:
    return (np.concatenate(parts).astype(dtype) if parts
            else np.zeros(0, dtype))


def run_fleet_round(engine: FleetEngine, params: Params,
                    clients_data: Sequence[ClientData],
                    cids: Sequence[int], budgets: Dict[int, int],
                    round_seed: int = 0, mode: str = "batched"
                    ) -> Tuple[Params, FleetRoundStats]:
    """Execute one cohort round; returns (aggregated params, stats).

    ``mode`` is ``"batched"`` (vmapped cohort groups) or ``"loop"``
    (per-client reference).  An empty cohort yields the round-start
    params and zero-length stats."""
    if mode not in ("batched", "loop"):
        raise ValueError(f"unknown fleet execution mode {mode!r}")
    cfg = engine.cfg
    obs = get_recorder()
    with obs.span("cohort_build", n_clients=len(cids)):
        groups = make_cohort_groups(clients_data, cids, budgets, cfg,
                                    round_seed)
    partials = []
    all_cids, all_m, all_b, all_core, all_work, all_loss = \
        [], [], [], [], [], []
    all_meds = []
    for g in groups:
        w = (g.m.astype(np.float64) if cfg.weight_by_samples
             else np.ones(g.n_clients))
        stack, losses, meds = engine.run_group(params, g,
                                               batched=(mode == "batched"))
        partials.append((stack, w))
        all_cids.append(g.cids)
        all_m.append(g.m)
        all_b.append(g.m if g.k == 0 else np.full(g.n_clients, g.k))
        all_core.append(np.full(g.n_clients, g.k > 0))
        all_work.append(cfg.epochs * g.m if g.k == 0
                        else g.m + (cfg.epochs - 1) * g.k
                        * np.ones(g.n_clients, np.int64))
        all_loss.append(losses)
        all_meds.append(meds)
    with obs.span("aggregate", n_groups=len(groups),
                  aggregator=cfg.aggregator):
        if obs.enabled:             # bytes entering the reduction
            obs.metrics.counter("aggregate.bytes").inc(sum(
                leaf.numel() * leaf.element_size()
                for stack, _ in partials for leaf in stack.values()))
        new_params = _aggregate_groups(partials, fallback=params)
    medoids: Dict[int, np.ndarray] = {}
    with obs.span("gather", n_groups=len(groups)):
        for g, meds in zip(groups, all_meds):
            if meds is not None:
                for cid, med in zip(g.cids, meds):
                    medoids[int(cid)] = med
    stats = FleetRoundStats(
        cids=_cat(all_cids, np.int64), m=_cat(all_m, np.int64),
        budgets=_cat(all_b, np.int64),
        used_coreset=_cat(all_core, bool),
        work=_cat(all_work, np.float64),
        losses=_cat(all_loss, np.float64), medoids=medoids)
    return new_params, stats


def run_fleet(model, clients_data: Sequence[ClientData],
              specs: Sequence[ClientSpec], cfg: FleetConfig, rounds: int,
              scheduler=None, trace: Optional[TraceConfig] = None,
              deadline: Optional[float] = None,
              straggler_pct: float = 30.0,
              test_data: Optional[Dict] = None, init_params=None,
              engine: str = "batched", eval_every: int = 1,
              faults=None, checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0, resume: bool = False,
              verbose: bool = False,
              device: DeviceLike = None) -> Dict[str, Any]:
    """Multi-round fleet driver: cohorts, budgets and batched execution.

    ``model`` is anything exposing the FL model interface, including a
    ``repro_torch.fed.fleet.workloads.FleetWorkload``; ``clients_data``
    the matching list of per-client field dicts.  ``engine`` is
    ``"batched"`` (vmapped cohort groups) or ``"loop"`` (the per-client
    reference).  ``scheduler`` (an ``AdaptiveParticipation`` or anything
    with its select / budget / observe / record_round protocol) picks
    each round's cohort and its budgets from observed capability;
    without one every client takes part with nominal-capability budgets.
    ``trace`` perturbs each (client, dispatch)'s realized duration as the
    sync server does.  ``device=None`` means the CUDA card; pass
    ``device="cpu"`` to run on the CPU.  ``init_params`` (a flat dict)
    defaults to ``model.init`` from a ``torch.Generator`` seeded with
    ``cfg.seed``.

    ``faults`` None and ``"none"`` run without faults.  Not ported yet,
    each raising ``NotImplementedError``: ``engine="sharded"`` (ROADMAP
    item 15), any other ``faults`` profile and robust
    ``cfg.aggregator`` values (item 12), ``checkpoint_dir``,
    ``checkpoint_every`` and ``resume`` (item 13).
    """
    if engine == "sharded":
        raise NotImplementedError(
            "the sharded fleet engine is not ported yet: ROADMAP item 15")
    if engine not in ("batched", "loop"):
        raise ValueError(f"unknown fleet engine {engine!r} "
                         f"(expected batched | loop)")
    if cfg.aggregator != "weighted_mean":
        raise NotImplementedError(
            f"fleet aggregator {cfg.aggregator!r} is not ported yet: robust "
            "aggregation is ROADMAP item 12 (only 'weighted_mean')")
    check_no_faults(faults)
    if checkpoint_dir is not None or checkpoint_every or resume:
        raise NotImplementedError(
            "fleet checkpoint / resume is not ported yet: ROADMAP item 13")
    dev = resolve_device(device)
    eng = FleetEngine(model, cfg, device=dev)
    if init_params is None:
        init_params = model.init(torch.Generator().manual_seed(cfg.seed),
                                 dev)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in init_params.items()}
    cost = resolve_cost(cfg.cost)
    if deadline is None:
        deadline = straggler_deadline(specs, cfg.epochs, straggler_pct,
                                      cost)
    cap_trace = CapabilityTrace(trace) if trace is not None else None
    eval_fn = (make_eval_fn(model, test_data, 512, device=dev)
               if test_data else None)
    # per-client dispatch cursors: the CapabilityTrace is defined per
    # (client, dispatch), as in the sync server
    tracei = DispatchTraceIndexer(len(specs), cap_trace)
    obs = active_recorder(verbose)
    obs.run_meta(runtime="fleet", engine=engine, requested_engine=engine,
                 n_clients=len(specs), rounds=rounds,
                 deadline=float(deadline), seed=cfg.seed,
                 aggregator=cfg.aggregator, faults="none", n_devices=1,
                 device=str(dev))

    history: List[RoundRecord] = []
    cohort_sizes: List[int] = []
    for r in range(rounds):
        t0 = time.perf_counter()
        rspan = obs.span_begin("round", round=r)
        with obs.span("cohort_select", round=r):
            if scheduler is not None:
                cohort = [int(c) for c in scheduler.select()]
                budgets = {cid: scheduler.budget(cid, deadline, cfg.epochs)
                           for cid in cohort}
            else:
                cohort = list(range(len(specs)))
                budgets = nominal_budgets(specs, deadline, cfg.epochs, cost)
        params, stats = run_fleet_round(eng, params, clients_data, cohort,
                                        budgets, round_seed=r, mode=engine)
        durations = []
        with obs.span("trace_account", round=r):
            for cid, work in zip(stats.cids, stats.work):
                s = specs[cid]
                k = tracei.begin(cid)
                # stats.work counts sample-visits; the cost model prices
                # them into duration seconds and scheduler work units
                dur = cost.duration(work, tracei.capability(s, k))
                dur *= tracei.jitter(s, k)
                durations.append(dur)
                obs.metrics.histogram("client_busy_s").observe(dur)
                if scheduler is not None:
                    scheduler.observe(int(cid), float(cost.work_units(work)),
                                      float(dur))
        train_loss = (float(np.mean(stats.losses)) if stats.losses.size
                      else float("nan"))
        if scheduler is not None:
            scheduler.record_round(train_loss)
        # honest τ accounting: a budget clamped to 1 or a slowdown
        # episode can still overrun τ
        n_violations = int(sum(d > deadline * (1.0 + 1e-9)
                               for d in durations))
        obs.metrics.counter("deadline_violations").inc(n_violations)
        rec = RoundRecord(
            round=r,
            sim_round_time=float(np.max(durations)) if durations else 0.0,
            client_times=[float(d) for d in durations],
            n_participants=len(cohort), n_dropped=0,
            n_coreset=int(stats.used_coreset.sum()), train_loss=train_loss,
            n_violations=n_violations)
        if eval_fn and (r % eval_every == 0 or r == rounds - 1):
            with obs.span("eval", round=r):
                rec.test_acc, rec.test_loss = eval_fn(params)
        history.append(rec)
        cohort_sizes.append(len(cohort))
        obs.span_end(rspan)
        rec.wall_time = time.perf_counter() - t0
        obs.event("round", runtime="fleet", engine=engine,
                  label=f"fleet/{engine}", round=r,
                  n_participants=len(cohort), n_dropped=0, n_corrupted=0,
                  n_coreset=rec.n_coreset, n_violations=n_violations,
                  sim_round_time=float(rec.sim_round_time),
                  wall_time_s=rec.wall_time,
                  train_loss=float(train_loss),
                  test_acc=float(rec.test_acc),
                  test_loss=float(rec.test_loss))
        obs.event("clients", round=r,
                  cids=[int(c) for c in stats.cids],
                  durations=[float(d) for d in durations],
                  violated=[bool(d > deadline * (1.0 + 1e-9))
                            for d in durations])

    return {
        "params": params,
        "history": history,
        "deadline": deadline,
        "engine": engine,
        "cohort_sizes": cohort_sizes,
        "aggregator": cfg.aggregator,
        "faults": "none",
        "strategy": "fedcore_fleet",
    }
