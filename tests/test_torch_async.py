"""The async slice: the port's aggregators and event runtime against the
JAX package's.

The aggregators (``FedAsync``, ``DelayedGradient``, ``FedBuff``,
``SyncWeightedMean`` with a round size, and the robust rules) take the
same updates, made from a numpy seed, on both sides: the streaming rules
within 1e-6 (float32 arithmetic in the reference's order), the
coordinate-wise median and Krum's selection exactly, the trimmed mean and
``norm_clip`` (which reduce in another order) within 1e-6.

``run_federated_async`` runs with ``FedCore`` on logistic regression and
the 14-px CNN for each streaming aggregator, on the clients, converted
initial weights and seed of ``tests/test_torch_fed.py`` (whose
capabilities leave no near-tied medoid choice): the event log must equal
the reference's byte for byte, the coreset indices of every selection,
the ``RoundRecord`` timing, participation and violation fields and the
telemetry's makespan, staleness histogram and counts must be equal, and
the final parameters within the reference's ``PARAMS_ATOL`` (2e-4 for
the CNN, 1e-5 otherwise).  One FedBuff run is cut by
``max_virtual_time``, which exercises the tail drain, the partial record
and the busy-time credit of unprocessed completions.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fed.aggregators as jagg  # noqa: E402
import repro.fed.strategies as jstrat  # noqa: E402
from repro.data import mnist_like_dataset, synthetic_dataset  # noqa: E402
from repro.fed.events import AsyncFLConfig as JAsyncFLConfig  # noqa: E402
from repro.fed.events import (  # noqa: E402
    run_federated_async as j_run_federated_async)
from repro.fed.simulator import ClientSpec as JClientSpec  # noqa: E402
from repro.fed.simulator import TraceConfig as JTraceConfig  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro.obs.schema import validate_records  # noqa: E402
import torch  # noqa: E402

import repro_torch.fed.aggregators as tagg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fed import (AsyncFLConfig, ClientSpec,  # noqa: E402
                             EventQueue, FedCore, LocalTrainer, TraceConfig,
                             run_federated_async)
from repro_torch.fed.simulator import straggler_deadline  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402
from repro_torch.obs import InMemorySink, Recorder, use_recorder  # noqa: E402
from repro_torch.utils.tree import tree_add, tree_scale, tree_sub  # noqa: E402,E501

torch.set_num_threads(1)

PARAMS_ATOL = {"cnn": 2e-4}
AGG_TOL = 1e-6
M = 30
CAPS = (1.0, 0.3, 0.8, 1.2, 0.25, 0.9)
CFG = dict(max_updates=8, concurrency=3, epochs=3, batch_size=8, lr=0.05,
           straggler_pct=40.0, record_every=3, seed=2)


# ---------------------------------------------------------------------------
# updates made from a numpy seed, as the reference's and the port's dicts
# ---------------------------------------------------------------------------

SHAPES = {"w": (6, 3), "b": (3,), "lstm0.wx": (4, 5)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax(tree):
    """The reference's nested tree of the dotted names."""
    out = {}
    for k, v in tree.items():
        node = out
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def _torch(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def assert_close(got, want, atol=AGG_TOL, exact=False):
    """A port dict against a reference tree."""
    want = params_from_jax("logreg", jax.tree.map(np.asarray, want),
                           device="cpu")
    assert set(got) == set(want)
    for k in want:
        if exact:
            assert torch.equal(got[k], want[k]), k
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=atol, rtol=0, err_msg=k)


def test_tree_ops_build_new_tensors():
    rng = np.random.default_rng(0)
    a, b = _torch(_tree(rng)), _torch(_tree(rng))
    keep = {k: v.clone() for k, v in a.items()}
    for out in (tree_add(a, b), tree_sub(a, b), tree_scale(a, 0.5)):
        assert all(out[k] is not a[k] for k in a)
    assert all(torch.equal(a[k], keep[k]) for k in a)
    assert all(torch.equal(tree_sub(a, b)[k], a[k] - b[k]) for k in a)


def test_event_queue_orders_by_time_then_push_order():
    q = EventQueue()
    q.push(5.0, "complete", cid=1, version=0)
    q.push(1.0, "dispatch", cid=2, version=0)
    q.push(1.0, "dispatch", cid=3, version=0)
    assert sorted(e.cid for e in q.events()) == [1, 2, 3]
    assert [q.pop().cid for _ in range(3)] == [2, 3, 1]
    assert len(q) == 0


def _streams():
    """(name, reference aggregator, port aggregator) for every streaming
    rule, including FedBuff weighted by samples with a server rate."""
    return [
        ("fedasync", jagg.FedAsync(), tagg.FedAsync()),
        ("fedasync_mixing", jagg.FedAsync(0.3, 1.0), tagg.FedAsync(0.3, 1.0)),
        ("delayed_grad", jagg.DelayedGradient(0.7, 1.0),
         tagg.DelayedGradient(0.7, 1.0)),
        ("fedbuff", jagg.FedBuff(3), tagg.FedBuff(3)),
        ("fedbuff_weighted", jagg.FedBuff(2, 1.0, 0.5, True),
         tagg.FedBuff(2, 1.0, 0.5, True)),
        ("sync_mean", jagg.SyncWeightedMean(round_size=3),
         tagg.SyncWeightedMean(round_size=3)),
        ("trimmed_mean", jagg.RobustAggregate("trimmed_mean", 4),
         tagg.RobustAggregate("trimmed_mean", 4)),
        ("median", jagg.RobustAggregate("median", 3),
         tagg.RobustAggregate("median", 3)),
        ("norm_clip", jagg.RobustAggregate("norm_clip", 3),
         tagg.RobustAggregate("norm_clip", 3)),
    ]


@pytest.mark.parametrize("case", range(len(_streams())),
                         ids=[n for n, _, _ in _streams()])
def test_streaming_aggregator_matches_reference(case):
    """Seven updates of mixed staleness through ``apply``, then
    ``flush`` of the partial buffer, then ``reset``: the same emissions
    and params as the reference's."""
    _, jrule, trule = _streams()[case]
    rng = np.random.default_rng(case)
    g = _tree(rng)
    jg, tg = _jax(g), _torch(g)
    for i in range(7):
        upd, base = _tree(rng), _tree(rng, 0.5)
        stale = int(rng.integers(0, 4))
        n = int(rng.integers(5, 50))
        j_out = jrule.apply(jg, jagg.ClientUpdate(_jax(upd), n, stale,
                                                  _jax(base)))
        t_base = _torch(base)
        t_out = trule.apply(tg, tagg.ClientUpdate(_torch(upd), n, stale,
                                                  t_base))
        assert (j_out is None) == (t_out is None), i
        if j_out is not None:
            assert_close(t_out, j_out)
            jg, tg = j_out, t_out
        assert torch.equal(t_base["w"], torch.as_tensor(base["w"]))
    j_tail, t_tail = jrule.flush(jg), trule.flush(tg)
    assert (j_tail is None) == (t_tail is None)
    if j_tail is not None:
        assert_close(t_tail, j_tail)
    assert trule.flush(tg) is None
    trule.apply(tg, tagg.ClientUpdate(_torch(_tree(rng)), 1, 0,
                                      _torch(_tree(rng))))
    trule.reset()
    assert trule.flush(tg) is None


def test_aggregator_error_cases_match_reference():
    g = _torch(_tree(np.random.default_rng(0)))
    for mod in (jagg, tagg):
        with pytest.raises(ValueError, match="mixing"):
            mod.FedAsync(mixing=0.0)
        with pytest.raises(ValueError, match="buffer_size"):
            mod.FedBuff(buffer_size=0)
        with pytest.raises(ValueError, match="server_lr"):
            mod.FedBuff(server_lr=0.0)
        with pytest.raises(ValueError, match="unknown robust method"):
            mod.RobustAggregate("mean")
        with pytest.raises(ValueError, match="round_size"):
            mod.RobustAggregate("median", round_size=0)
    with pytest.raises(ValueError, match="base_params"):
        tagg.DelayedGradient().apply(g, tagg.ClientUpdate(g, 1))
    agg = tagg.SyncWeightedMean()
    with pytest.raises(ValueError, match="round_size"):
        agg.apply(g, tagg.ClientUpdate(g, 1))
    assert agg.flush(g) is None
    stacked = tagg.stack_params([g, g])
    with pytest.raises(ValueError, match="unknown combine method"):
        tagg.robust_combine(stacked, "mean")
    with pytest.raises(ValueError, match="norm_clip needs base"):
        tagg.robust_combine(stacked, "norm_clip")
    with pytest.raises(ValueError, match="empty update stack"):
        tagg.robust_combine({}, "median")
    assert tagg.robust_combine({}, "median", base=g) is g
    with pytest.raises(ValueError, match="all-zero weights"):
        tagg.robust_combine(stacked, "weighted_mean", weights=[0.0, 0.0])
    with pytest.raises(ValueError, match="at least one tree"):
        tagg.stack_params([])
    for name, factory in tagg.AGGREGATORS.items():
        assert factory().flush(g) is None, name
    assert set(tagg.AGGREGATORS) == set(jagg.AGGREGATORS)
    assert tagg.ROBUST_METHODS == jagg.ROBUST_METHODS
    assert tagg.polynomial_staleness(3, 0.5) == \
        jagg.polynomial_staleness(3, 0.5)


@pytest.mark.parametrize("c", [5, 6])
@pytest.mark.parametrize("method", ["weighted_mean", *jagg.ROBUST_METHODS])
def test_robust_combine_matches_reference(method, c):
    """Every rule at an odd and an even client count, with a boosted
    outlier: the median (the midpoint of the middle pair at even C) and
    Krum's selection exactly, the others within 1e-6."""
    rng = np.random.default_rng(c)
    base = _tree(rng)
    trees = [_tree(rng) for _ in range(c)]
    trees[1] = {k: 8.0 * v for k, v in trees[1].items()}
    weights = [float(w) for w in rng.integers(1, 40, size=c)]
    j_stack = jagg.stack_params([_jax(t) for t in trees])
    t_stack = tagg.stack_params([_torch(t) for t in trees])
    want = jagg.robust_combine(j_stack, method, weights=weights,
                               base=_jax(base))
    got = tagg.robust_combine(t_stack, method, weights=weights,
                              base=_torch(base))
    if method in ("krum", "multi_krum"):
        assert np.array_equal(tagg.krum_select(t_stack, multi=3),
                              jagg.krum_select(j_stack, multi=3))
    assert_close(got, want, exact=method in ("median", "krum"))


def test_krum_and_norm_clip_flatten_in_reference_layout():
    """A CNN's stacked updates: the port's OIHW kernels flattened in the
    JAX HWIO layout and leaf order give the reference's selection and
    clipped mean."""
    rng = np.random.default_rng(4)
    shapes = {"conv1": (5, 5, 1, 4), "b1": (4,), "w_out": (12, 10),
              "b_out": (10,)}

    def tree(scale=1.0):
        return {k: (scale * rng.normal(size=s)).astype(np.float32)
                for k, s in shapes.items()}

    base, trees = tree(), [tree() for _ in range(7)]
    layouts = tsmall.SmallCNN.reference_layouts
    j_stack = jagg.stack_params([jax.tree.map(jnp.asarray, t)
                                 for t in trees])
    t_stack = tagg.stack_params([params_from_jax("cnn", t, device="cpu")
                                 for t in trees])
    for multi in (1, 3):
        assert np.array_equal(
            tagg.krum_select(t_stack, multi=multi, layouts=layouts),
            jagg.krum_select(j_stack, multi=multi))
    want = params_from_jax("cnn", jax.tree.map(np.asarray,
                           jagg.robust_combine(j_stack, "norm_clip",
                                               base=jax.tree.map(
                                                   jnp.asarray, base))),
                           device="cpu")
    got = tagg.robust_combine(t_stack, "norm_clip",
                              base=params_from_jax("cnn", base,
                                                   device="cpu"),
                              layouts=layouts)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=AGG_TOL, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# run_federated_async against the reference
# ---------------------------------------------------------------------------

def _data(name):
    n = len(CAPS)
    if name == "logreg":
        clients = synthetic_dataset(0.5, 0.5, n_clients=n,
                                    mean_samples=3 * M, std_samples=1, seed=1)
    else:
        clients = mnist_like_dataset(n_clients=n, mean_samples=3 * M,
                                     std_samples=1, size=14, seed=1)
    return [{k: v[:M] for k, v in d.items()} for d in clients]


def _models(name):
    if name == "logreg":
        return jsmall.LogisticRegression(), tsmall.LogisticRegression()
    return (jsmall.SmallCNN(image_size=14, channels=(4, 8)),
            tsmall.SmallCNN(image_size=14, channels=(4, 8)))


def _init(name, jm):
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if name == "logreg":          # the reference's zero init, perturbed
        rng = np.random.default_rng(5)
        jp = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in jp.items()}
    return jp


AGGS = {
    "fedasync": lambda mod: mod.FedAsync(),
    "fedbuff": lambda mod: mod.FedBuff(buffer_size=3),
    "delayed_grad": lambda mod: mod.DelayedGradient(),
    "sync_mean": lambda mod: mod.SyncWeightedMean(round_size=3),
}


class RecordingFedCore(FedCore):
    """FedCore that keeps every selected coreset, in selection order."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.selected = []

    def select_coreset(self, feats, budget):
        cs = super().select_coreset(feats, budget)
        self.selected.append(cs.indices.cpu().numpy())
        return cs


def run_both(name, agg, monkeypatch, faults=None, **over):
    """The reference's and the port's run on the same clients, weights
    and seed; returns (port output, reference output, port coresets,
    reference coresets)."""
    jm, tm = _models(name)
    train = _data(name)
    jp = _init(name, jm)
    kw = dict(CFG, **over)
    trace = kw.pop("trace", None)
    j_selected = []
    build = jstrat.build_coreset

    def recording_build(feats, budget, **kwargs):
        cs = build(feats, budget, **kwargs)
        j_selected.append(np.asarray(cs.indices))
        return cs

    monkeypatch.setattr(jstrat, "build_coreset", recording_build)
    jout = j_run_federated_async(
        jm, train, [JClientSpec(i, M, c) for i, c in enumerate(CAPS)],
        jstrat.FedCore(jstrat.LocalTrainer(jm, kw["lr"], kw["batch_size"])),
        JAsyncFLConfig(**kw, trace=None if trace is None
                       else JTraceConfig(**trace)),
        aggregator=AGGS[agg](jagg), init_params=jp, faults=faults)
    strategy = RecordingFedCore(LocalTrainer(tm, kw["lr"], kw["batch_size"],
                                             device="cpu"))
    tout = run_federated_async(
        tm, train, [ClientSpec(i, M, c) for i, c in enumerate(CAPS)],
        strategy, AsyncFLConfig(**kw, trace=None if trace is None
                                else TraceConfig(**trace)),
        aggregator=AGGS[agg](tagg),
        init_params=params_from_jax(name, jp, device="cpu"), faults=faults,
        device="cpu")
    return tout, jout, strategy.selected, j_selected


def check_async_against_reference(name, tout, jout, got_sel, want_sel):
    assert tout["event_log"] == jout["event_log"]
    for key in ("deadline", "strategy", "aggregator", "faults", "version"):
        assert tout[key] == jout[key], key
    assert len(got_sel) == len(want_sel)
    for got, want in zip(got_sel, want_sel):
        np.testing.assert_array_equal(got, want)
    assert len(tout["history"]) == len(jout["history"])
    for a, b in zip(tout["history"], jout["history"]):
        assert (a.round, a.sim_round_time, a.client_times, a.n_participants,
                a.n_dropped, a.n_coreset, a.n_violations) == \
            (b.round, b.sim_round_time, b.client_times, b.n_participants,
             b.n_dropped, b.n_coreset, b.n_violations)
        np.testing.assert_allclose(a.train_loss, b.train_loss,
                                   atol=PARAMS_ATOL.get(name, 1e-5))
    tt, jt = tout["telemetry"], jout["telemetry"]
    assert set(tt) == set(jt)
    np.testing.assert_array_equal(tt.pop("staleness_hist"),
                                  jt.pop("staleness_hist"))
    tt.pop("wall_time"), jt.pop("wall_time")
    assert tt == jt
    want = params_from_jax(name, jax.tree.map(np.asarray, jout["params"]),
                           device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(tout["params"][k].numpy(), v.numpy(),
                                   atol=PARAMS_ATOL.get(name, 1e-5),
                                   err_msg=k)


@pytest.mark.parametrize("agg", sorted(AGGS))
@pytest.mark.parametrize("name", ["logreg", "cnn"])
def test_async_run_matches_reference(name, agg, monkeypatch):
    trace = dict(seed=2) if name == "logreg" else None
    tout, jout, got, want = run_both(name, agg, monkeypatch, trace=trace)
    # the coreset path ran, and the buffers merged more than one update
    assert sum(h.n_coreset for h in tout["history"]) > 0
    assert tout["telemetry"]["n_dispatches"] > CFG["max_updates"] or \
        agg in ("fedasync", "delayed_grad")
    check_async_against_reference(name, tout, jout, got, want)


def test_async_cutoff_drains_the_buffer_like_reference(monkeypatch):
    """``max_virtual_time`` mid-run: the partial FedBuff buffer is
    flushed, a partial record written and the unprocessed completions'
    busy time credited, as the reference does."""
    deadline = straggler_deadline([ClientSpec(i, M, c)
                                   for i, c in enumerate(CAPS)],
                                  CFG["epochs"], CFG["straggler_pct"])
    tout, jout, got, want = run_both(
        "logreg", "fedbuff", monkeypatch, max_updates=50,
        max_virtual_time=1.5 * deadline, trace=dict(seed=2))
    assert tout["telemetry"]["n_updates_applied"] < 50
    assert tout["telemetry"]["makespan"] <= 1.5 * deadline
    check_async_against_reference("logreg", tout, jout, got, want)


def test_async_run_is_deterministic_in_the_seed():
    tm = tsmall.LogisticRegression()
    train = _data("logreg")
    specs = [ClientSpec(i, M, c) for i, c in enumerate(CAPS)]

    def run(seed):
        return run_federated_async(
            tm, train, specs, FedCore(LocalTrainer(tm, 0.05, 8,
                                                   device="cpu")),
            AsyncFLConfig(**dict(CFG, seed=seed), trace=TraceConfig(seed=2)),
            aggregator=tagg.FedBuff(3), device="cpu")

    a, b, c = run(2), run(2), run(3)
    assert a["event_log"] == b["event_log"]
    assert all(torch.equal(a["params"][k], b["params"][k])
               for k in a["params"])
    assert a["event_log"] != c["event_log"]


def test_port_async_jsonl_passes_reference_schema():
    tm = tsmall.LogisticRegression()
    train = _data("logreg")
    sink = InMemorySink()
    with use_recorder(Recorder([sink])):
        out = run_federated_async(
            tm, train, [ClientSpec(i, M, c) for i, c in enumerate(CAPS)],
            FedCore(LocalTrainer(tm, 0.05, 8, device="cpu")),
            AsyncFLConfig(**CFG), aggregator=tagg.FedBuff(3),
            test_data=train[0], device="cpu")
    validate_records(sink.records)
    spans = {r["name"] for r in sink.records if r["kind"] == "span"}
    assert {"round", "local_update", "aggregate", "eval", "selection"} <= \
        spans
    rounds = [r for r in sink.records
              if r["kind"] == "event" and r["name"] == "round"]
    assert [r["data"]["n_coreset"] for r in rounds] == \
        [h.n_coreset for h in out["history"]]
    telemetry = [r for r in sink.records
                 if r["kind"] == "event" and r["name"] == "telemetry"]
    assert telemetry[0]["data"]["makespan"] == out["telemetry"]["makespan"]
    assert dataclasses.asdict(out["history"][-1])["round"] == \
        len(out["history"]) - 1
