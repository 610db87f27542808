"""The fleet engine's CUDA graphs of its vmapped steps
(``repro_torch.fed.fleet._graphs``).

On the CPU the engine captures nothing and runs every step eagerly.  The
cache's rules (keys, the short-group rule, eviction, no capture under
the profiler, the launch counts a replay adds) are held here on the CPU
with an emulated capture, whose replay runs the step on the static
buffers.  The tests marked ``cuda`` hold the real graphs to the eager
batched path bit for bit on the card; run them there with
``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_fleet_graphs.py``.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.fed.fleet import (FleetConfig, FleetEngine, get_workload,
                                   make_cohort_groups, run_fleet_round)
from repro_torch.fed.fleet import _graphs as fg
from repro_torch.kernels import ops
from repro_torch.obs import InMemorySink, Recorder, use_recorder

CFG = dict(epochs=5, batch_size=8, lr=0.05, seed=0)
# (size, budget) of each client: a full-set group of three, straggler
# groups below the distance-free cutover (M = 128) and above it
# (M = 512, one of them a group of one client)
CLIENTS = ((20, 10 ** 9), (22, 10 ** 9), (30, 10 ** 9), (100, 16),
           (110, 16), (300, 16), (260, 64), (270, 64))
COUNTERS = ("fleet.graph_captures", "fleet.graph_replays",
            "fleet.eager_steps", "fleet.graph_evictions")


def _fleet(workload="cnn"):
    """The clients of ``CLIENTS``, cut from one pool of the workload's
    data, and their budgets."""
    wl = get_workload(workload)
    pool = wl.make_clients(n_clients=8, seed=0, mean_samples=200.0,
                           std_samples=10.0)
    fields = {f: np.concatenate([c[f] for c in pool]) for f in pool[0]}
    clients, at = [], 0
    for m, _ in CLIENTS:
        clients.append({f: v[at:at + m] for f, v in fields.items()})
        at += m
    budgets = {i: b for i, (_, b) in enumerate(CLIENTS)}
    return wl, clients, budgets


def _steps(groups, epochs):
    """Vmapped steps of a round: (mini-batch steps, coreset steps)."""
    sgd = sum((epochs if g.k == 0 else 1) * g.valid.shape[1]
              // CFG["batch_size"] for g in groups)
    core = sum(max(epochs - 1, 1) for g in groups if g.k > 0)
    return sgd, core


def _keys(groups):
    """Distinct step shapes of a round: (C, M) of each mini-batch step,
    (C, k) of each coreset step."""
    return len({(g.n_clients, g.valid.shape[1]) for g in groups}
               | {("core", g.n_clients, g.k) for g in groups if g.k > 0})


def _rounds(engine, params, clients, budgets, rounds=2):
    """``rounds`` batched rounds; per round (params, stats, counters)."""
    out = []
    for r in range(rounds):
        rec = Recorder([InMemorySink()])
        with use_recorder(rec):
            params, stats = run_fleet_round(
                engine, params, clients, list(range(len(clients))),
                budgets, round_seed=r)
        out.append((params, stats,
                    {n: rec.metrics.counter(n).value for n in COUNTERS}))
    return out


def _same_rounds(a, b):
    for (pa, sa, _), (pb, sb, _) in zip(a, b):
        assert all(torch.equal(pa[k], pb[k]) for k in pb)
        assert np.array_equal(sa.losses, sb.losses)
        assert sa.medoids.keys() == sb.medoids.keys()
        assert all(np.array_equal(sa.medoids[c], sb.medoids[c])
                   for c in sb.medoids)


class _EmulatedGraph:
    """A replay that runs the step on the captured static buffers, as
    the graph's kernels would."""

    def __init__(self, step, g):
        self.step, self.g = step, g

    def replay(self):
        g = self.g
        new_p, loss = self.step(g.p, *g.fixed, *g.varying)
        for k, v in g.p.items():
            v.copy_(new_p[k])
        g.loss.copy_(loss)


def _emulate(monkeypatch, engine, launches=None):
    """Let ``engine``'s ``StepGraphs`` capture CPU tensors: a capture
    makes static buffers and an ``_EmulatedGraph``; each replay adds
    ``launches`` to ``ops.LAUNCHES``."""
    def capture(self, step, p, fixed, varying):
        sp, sf, sv = fg._static(p), fg._static(fixed), fg._static(varying)
        for s, v in ((sp, p), (sf, fixed), (sv, varying)):
            fg._load(s, v)
        _, loss = step(sp, *sf, *sv)
        g = fg._Captured(None, sp, sf, sv, torch.empty_like(loss),
                         dict(launches or {}))
        g.graph = _EmulatedGraph(step, g)
        return g

    monkeypatch.setattr(fg.StepGraphs, "_capture", capture)
    engine._graphs.device = torch.device("cuda")


def test_cpu_engine_captures_nothing_and_steps_as_before():
    """On CPU tensors every step runs eagerly: no capture, no replay,
    every span stamped ``graphed=False``, and a full-set group's params
    and losses are those of the plain loop of vmapped steps."""
    torch.set_num_threads(2)
    wl, clients, budgets = _fleet()
    cfg = FleetConfig(**CFG)
    groups = make_cohort_groups(clients, list(range(len(clients))),
                                budgets, cfg)
    engine = FleetEngine(wl, cfg, device="cpu")
    params = wl.init(torch.Generator().manual_seed(0), "cpu")
    sink = InMemorySink()
    rec = Recorder([sink])
    with use_recorder(rec):
        p, losses, _ = engine.run_group(params, groups[0])
        for g in groups[1:]:
            engine.run_group(params, g)
    sgd, core = _steps(groups, CFG["epochs"])
    assert {n: rec.metrics.counter(n).value for n in COUNTERS} == {
        "fleet.graph_captures": 0, "fleet.graph_replays": 0,
        "fleet.eager_steps": sgd + core, "fleet.graph_evictions": 0}
    stamped = [r["attrs"]["graphed"] for r in sink.records
               if r["kind"] == "span"
               and r["name"] in ("sgd_steps", "coreset_epochs")]
    assert len(stamped) == len(groups) + sum(g.k > 0 for g in groups)
    assert not any(stamped)
    g = groups[0]
    assert g.k == 0
    c = g.n_clients
    data = {f: torch.as_tensor(v) for f, v in g.data.items()}
    w = torch.as_tensor(g.valid.astype(np.float32))
    idx = engine._batch_indices(g, slice(None))
    q = {k: v.expand((c,) + v.shape) for k, v in params.items()}
    for t in range(idx.shape[1]):
        q, loss = engine._vm_sgd_step(q, data, w, idx[:, t])
    assert all(torch.equal(p[k], q[k]) for k in q)
    assert np.array_equal(losses, loss.numpy())


def test_emulated_graphs_match_eager_rounds_and_count(monkeypatch):
    """Through the cache's whole path (static buffers, the per-step
    indices, the clones it returns), two rounds equal the eager rounds
    bit for bit; round 1 captures each distinct step shape once, round
    2 captures nothing, and both replay every step."""
    torch.set_num_threads(2)
    wl, clients, budgets = _fleet()
    cfg = FleetConfig(**CFG)
    groups = make_cohort_groups(clients, list(range(len(clients))),
                                budgets, cfg)
    params = wl.init(torch.Generator().manual_seed(0), "cpu")
    eager = _rounds(FleetEngine(wl, cfg, device="cpu"), params, clients,
                    budgets)
    engine = FleetEngine(wl, cfg, device="cpu")
    _emulate(monkeypatch, engine, launches={"rmsnorm": 2})
    before = ops.LAUNCHES["rmsnorm"]
    graphed = _rounds(engine, params, clients, budgets)
    _same_rounds(graphed, eager)
    steps = sum(_steps(groups, CFG["epochs"]))
    assert [r[2] for r in graphed] == [
        {"fleet.graph_captures": n, "fleet.graph_replays": steps,
         "fleet.eager_steps": 0, "fleet.graph_evictions": 0}
        for n in (_keys(groups), 0)]
    assert ops.LAUNCHES["rmsnorm"] - before == 2 * 2 * steps


def _toy_step(p, x, ix):
    return {"w": p["w"] + x[ix]}, p["w"].sum()


def _toy_run(graphs, n, width=3):
    p = {"w": torch.zeros(width)}
    x = torch.arange(float(width) * 4).reshape(4, width)
    return graphs.run(_toy_step, p, (x,), lambda t: (torch.tensor(t % 4),),
                      n)


def _counts(rec):
    return [rec.metrics.counter(n).value for n in COUNTERS]


def test_short_groups_run_eagerly_until_their_shape_is_captured(
        monkeypatch):
    """A new shape with fewer than ``MIN_CAPTURE_STEPS`` steps runs
    eagerly; once a longer run captured it, a run of one step replays."""
    engine = FleetEngine(get_workload("mlp"), FleetConfig(**CFG),
                         device="cpu")
    _emulate(monkeypatch, engine)
    graphs, n = engine._graphs, fg.MIN_CAPTURE_STEPS
    rec = Recorder([])
    with use_recorder(rec):
        short = _toy_run(graphs, n - 1)
        assert not short[2] and _counts(rec) == [0, 0, n - 1, 0]
        long = _toy_run(graphs, n)
        assert long[2] and _counts(rec) == [1, n, n - 1, 0]
        again = _toy_run(graphs, n - 1)
        assert again[2] and _counts(rec) == [1, 2 * n - 1, n - 1, 0]
    assert torch.equal(again[0]["w"], short[0]["w"])
    assert torch.equal(again[1], short[1])


def test_cache_evicts_the_least_recently_used_shape(monkeypatch):
    monkeypatch.setattr(fg, "CACHE_SIZE", 2)
    engine = FleetEngine(get_workload("mlp"), FleetConfig(**CFG),
                         device="cpu")
    _emulate(monkeypatch, engine)
    graphs, n = engine._graphs, fg.MIN_CAPTURE_STEPS
    rec = Recorder([])
    with use_recorder(rec):
        for width in (1, 2, 1, 3):          # 2 is the least recent
            _toy_run(graphs, n, width)
        assert _counts(rec)[0] == 3 and _counts(rec)[3] == 1
        _toy_run(graphs, n, 1)
        assert _counts(rec)[0] == 3
        _toy_run(graphs, n, 2)              # captured anew
        assert _counts(rec)[0] == 4 and _counts(rec)[3] == 2
    assert len(graphs._cache) == 2


def test_no_capture_under_the_profiler(monkeypatch):
    """A new shape seen while the profiler runs stays eager; a shape
    captured before replays under it."""
    engine = FleetEngine(get_workload("mlp"), FleetConfig(**CFG),
                         device="cpu")
    _emulate(monkeypatch, engine)
    graphs, n = engine._graphs, fg.MIN_CAPTURE_STEPS
    rec = Recorder([])
    with use_recorder(rec):
        _toy_run(graphs, n, 1)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            assert not _toy_run(graphs, n, 2)[2]
            assert _toy_run(graphs, n, 1)[2]
    assert _counts(rec) == [1, 2 * n, n, 0]


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    """TF32 off, and deterministic cuDNN: cuDNN's default convolution
    backward may sum in another order from one call to the next, and
    then two eager runs differ in their last bits too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    flags = ((torch.backends.cuda.matmul, "allow_tf32", False),
             (torch.backends.cudnn, "allow_tf32", False),
             (torch.backends.cudnn, "deterministic", True),
             (torch.backends.cudnn, "benchmark", False))
    prev = [getattr(owner, name) for owner, name, _ in flags]
    for owner, name, value in flags:
        setattr(owner, name, value)
    yield torch.device("cuda")
    for (owner, name, _), value in zip(flags, prev):
        setattr(owner, name, value)


def _eager(engine):
    """``engine`` with its graphs off: every step runs eagerly."""
    engine._graphs._lookup = lambda *args: None
    return engine


@pytest.mark.cuda
def test_graphed_fleet_rounds_match_eager_bit_for_bit(cuda):
    """Two SmallCNN rounds (a full-set group, stragglers both sides of
    M = 256, a group of one client): the graphed batched path gives the
    eager batched path's params, losses and medoids bit for bit; round
    1 captures each distinct step shape once, round 2 none, and both
    replay every step."""
    wl, clients, budgets = _fleet()
    cfg = FleetConfig(**CFG)
    groups = make_cohort_groups(clients, list(range(len(clients))),
                                budgets, cfg)
    assert {g.n_clients for g in groups if g.valid.shape[1] >= 256} >= {1}
    assert any(g.k > 0 and g.valid.shape[1] < 256 for g in groups)
    params = wl.init(torch.Generator().manual_seed(0), cuda)
    eager = _rounds(_eager(FleetEngine(wl, cfg, device=cuda)), params,
                    clients, budgets)
    graphed = _rounds(FleetEngine(wl, cfg, device=cuda), params, clients,
                      budgets)
    _same_rounds(graphed, eager)
    steps = sum(_steps(groups, CFG["epochs"]))
    assert [r[2] for r in graphed] == [
        {"fleet.graph_captures": n, "fleet.graph_replays": steps,
         "fleet.eager_steps": 0, "fleet.graph_evictions": 0}
        for n in (_keys(groups), 0)]
    assert all(r[2]["fleet.eager_steps"] == steps for r in eager)


@pytest.mark.cuda
def test_translm_replays_count_their_kernel_launches(cuda, monkeypatch):
    """A translm fleet group's replays each add the launches of kernels
    7 and 8 that its step makes, and the group equals its eager run bit
    for bit, launch counts included."""
    wl, clients, budgets = _fleet("translm")
    cfg = FleetConfig(**CFG)
    group = make_cohort_groups(clients, list(range(len(clients))),
                               budgets, cfg)[0]
    params = wl.init(torch.Generator().manual_seed(0), cuda)

    def run(engine):
        before = dict(ops.LAUNCHES)
        out = engine.run_group(params, group)
        return out, {k: ops.LAUNCHES[k] - before[k]
                     for k in ("flash_attention", "rmsnorm")}

    (pe, le, _), eager_launches = run(_eager(FleetEngine(wl, cfg,
                                                         device=cuda)))
    engine = FleetEngine(wl, cfg, device=cuda)
    run(engine)                             # captures
    per_replay = []
    replay = fg._Captured.replay

    def counting(self, varying):
        before = dict(ops.LAUNCHES)
        replay(self, varying)
        per_replay.append({k: ops.LAUNCHES[k] - before[k]
                           for k in ("flash_attention", "rmsnorm")})

    monkeypatch.setattr(fg._Captured, "replay", counting)
    (pg, lg, _), graphed_launches = run(engine)
    assert all(torch.equal(pg[k], pe[k]) for k in pe)
    assert np.array_equal(lg, le)
    steps = CFG["epochs"] * group.valid.shape[1] // CFG["batch_size"]
    assert len(per_replay) == steps
    assert all(n["flash_attention"] > 0 and n["rmsnorm"] > 0
               and n == per_replay[0] for n in per_replay)
    assert graphed_launches == eager_launches


class _CollectorWatch:
    """A model whose loss notes, inside a capture, whether the cyclic
    collector is on."""

    def __init__(self, model):
        self.model, self.seen = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def loss(self, params, batch):
        if torch.cuda.is_current_stream_capturing():
            self.seen.append(gc.isenabled())
        return self.model.loss(params, batch)


@pytest.mark.cuda
def test_capture_runs_with_the_collector_off(cuda):
    """The collector may free another engine's graphs, which CUDA
    forbids inside a capture: it is off for the capture and on again
    after it."""
    wl, clients, budgets = _fleet()
    cfg = FleetConfig(**CFG)
    group = make_cohort_groups(clients, list(range(len(clients))),
                               budgets, cfg)[0]
    watch = _CollectorWatch(wl)
    engine = FleetEngine(watch, cfg, device=cuda)
    assert gc.isenabled()
    engine.run_group(wl.init(torch.Generator().manual_seed(0), cuda), group)
    assert watch.seen == [False] and gc.isenabled()
