"""The fault axis and robust aggregation against the JAX package's.

``FaultTrace`` must draw what the reference draws (Byzantine set, dropout
per (client, dispatch), churn masks and transitions) for every profile of
``FAULT_PROFILES``, and ``dirichlet_label_skew`` must give the same
bytes.  ``corrupt_update`` / ``corrupt_stacked`` must corrupt the
Byzantine lanes as the reference does in each mode (gaussian noise on
the right leaves of a CNN whose kernels the port stores OIHW) and leave
honest lanes ``torch.equal`` to their input.

Every profile then runs through each runtime against the reference's on
the same data, converted initial weights and seed, with a robust
aggregator chosen per profile so that each rule runs at least once:
``run_federated`` and ``run_federated_async`` with ``FedCore`` on
logistic regression (the clients of ``tests/test_torch_fed.py``),
``run_fleet`` on the ``mlp`` workload in both of the port's engines
against the reference's loop engine (the fleet of
``tests/test_torch_fleet.py``: at 8 clients instead of its 6, client 3's
k = 16 of 21 meets a tied medoid choice, float64 objectives both
8.704524004355925), and ``run_scenario`` on ``mlp`` (where the
label-skew axis repartitions the data).  The fault counters,
each round's dropped and participation counts (and, in the fleet, each
client's dropped and corrupted flags) must be equal, the event logs of
the async runs byte for byte, and the final parameters within 1e-5
(the conformance matrix's ``PARAMS_ATOL`` for both models).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fed.aggregators as jagg  # noqa: E402
import repro.fed.fleet.batched as jb  # noqa: E402
import repro.fed.fleet.faults as jf  # noqa: E402
import repro.fed.strategies as jstrat  # noqa: E402
from repro.data import synthetic_dataset  # noqa: E402
from repro.data.partition import train_test_split_clients  # noqa: E402
from repro.fed.events import AsyncFLConfig as JAsyncFLConfig  # noqa: E402
from repro.fed.events import (  # noqa: E402
    run_federated_async as j_run_federated_async)
from repro.fed.fleet import scenarios as js  # noqa: E402
from repro.fed.fleet import workloads as jw  # noqa: E402
from repro.fed.server import FLConfig as JFLConfig  # noqa: E402
from repro.fed.server import run_federated as j_run_federated  # noqa: E402
from repro.fed.simulator import ClientSpec as JClientSpec  # noqa: E402
from repro.fed.simulator import make_client_specs  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro.obs import InMemorySink as JInMemorySink  # noqa: E402
from repro.obs import Recorder as JRecorder  # noqa: E402
from repro.obs import use_recorder as j_use_recorder  # noqa: E402
import torch  # noqa: E402

import repro_torch.fed.aggregators as tagg  # noqa: E402
import repro_torch.fed.fleet.batched as tb  # noqa: E402
import repro_torch.fed.fleet.faults as tf  # noqa: E402
import repro_torch.fed.strategies as tstrat  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.kmedoids import medoid_objective_f64  # noqa: E402
from repro_torch.fed import (AsyncFLConfig, ClientSpec, FedCore,  # noqa: E402
                             FLConfig, LocalTrainer, run_federated,
                             run_federated_async)
from repro_torch.fed.fleet import (FleetConfig, get_workload,  # noqa: E402
                                   run_fleet, run_scenario)
from repro_torch.models import small as tsmall  # noqa: E402
from repro_torch.obs import InMemorySink, Recorder, use_recorder  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5
PROFILES = sorted(jf.FAULT_PROFILES)
# the combine rule each profile runs with: every robust rule at least once
AGGREGATOR = {"none": "weighted_mean", "dropout": "trimmed_mean",
              "churn": "median", "byzantine_signflip": "krum",
              "byzantine_noise": "multi_krum", "byzantine_boost": "norm_clip",
              "label_skew": "weighted_mean", "hostile": "trimmed_mean"}
# the fault counters and gauges both packages keep
FAULT_METRICS = ("faults.dropped_updates", "faults.corrupted_updates",
                 "faults.churn_joins", "faults.churn_leaves", "drops",
                 "dispatches", "faults.n_present",
                 "faults.participation_frac")


# ---------------------------------------------------------------------------
# the fault primitives
# ---------------------------------------------------------------------------

def test_profile_registry_equals_reference():
    assert [dataclasses.asdict(p) for p in tf.FAULT_PROFILES.values()] == \
        [dataclasses.asdict(p) for p in jf.FAULT_PROFILES.values()]
    assert tf.CORRUPT_MODES == jf.CORRUPT_MODES
    assert tf.get_fault_profile(None) is None
    assert tf.get_fault_profile("dropout") is tf.FAULT_PROFILES["dropout"]
    p = tf.FaultProfile("mine", dropout_prob=0.5)
    assert tf.get_fault_profile(p) is p
    with pytest.raises(ValueError, match="unknown fault profile"):
        tf.get_fault_profile("not_a_profile")
    with pytest.raises(TypeError):
        tf.get_fault_profile(3)
    with pytest.raises(ValueError, match="corrupt_mode"):
        tf.FaultProfile(name="bad", corrupt_mode="exotic", corrupt_frac=0.1)
    assert tf.make_fault_trace("label_skew", 4, 0) == (None, "label_skew")
    assert tf.make_fault_trace(None, 4, 0) == (None, "none")


@pytest.mark.parametrize("profile", PROFILES)
def test_fault_trace_draws_equal_reference(profile):
    for n, seed in ((40, 7), (6, 0)):
        got = tf.FaultTrace(tf.FAULT_PROFILES[profile], n, seed=seed)
        want = jf.FaultTrace(jf.FAULT_PROFILES[profile], n, seed=seed)
        assert got.byzantine.tobytes() == want.byzantine.tobytes()
        # out of order on the port's side: the draws are per ordinal
        for cid, k in ((3, 4), (3, 0), (0, 2)):
            assert got.dropped(cid, k) == want.dropped(cid, k)
        assert [got.dropped(c, k) for c in range(n) for k in range(5)] == \
            [want.dropped(c, k) for c in range(n) for k in range(5)]
        for t in (5, 0, 3):
            mask, joins, leaves = got.churn_step(t)
            wmask, wjoins, wleaves = want.churn_step(t)
            assert mask.tobytes() == wmask.tobytes()
            assert (joins, leaves) == (wjoins, wleaves)
        assert got.corrupt_factor() == want.corrupt_factor()


@pytest.mark.parametrize("alpha", [0.2, 5.0])
def test_dirichlet_label_skew_gives_reference_bytes(alpha):
    rng = np.random.default_rng(0)
    flat = [{"x": rng.normal(size=(m, 3)).astype(np.float32),
             "y": rng.integers(0, 8, m).astype(np.int32)}
            for m in (40, 12, 33, 25)]
    seq = jw.get_workload("charlm").make_clients(n_clients=5, seed=1)
    for clients in (flat, seq):
        got = tf.dirichlet_label_skew(clients, alpha, seed=3)
        want = jf.dirichlet_label_skew(clients, alpha, seed=3)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for f in w:
                assert g[f].dtype == w[f].dtype
                assert g[f].tobytes() == np.asarray(w[f]).tobytes()
    with pytest.raises(ValueError, match="alpha"):
        tf.dirichlet_label_skew(flat, 0.0)
    with pytest.raises(ValueError, match="'label'"):
        tf.dirichlet_label_skew(flat, 0.5, label_field="label")
    assert tf.dirichlet_label_skew([], 0.5) == []


CNN = jsmall.SmallCNN(image_size=8, channels=(2, 3))
LAYOUTS = tsmall.SmallCNN.reference_layouts


def _cnn_tree(rng):
    return jax.tree.map(
        lambda x: (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32),
        jax.tree.map(np.asarray, CNN.init(jax.random.PRNGKey(0))))


@pytest.mark.parametrize("profile", ["byzantine_noise", "byzantine_signflip",
                                     "byzantine_boost", "none"])
def test_corruption_matches_reference(profile):
    """Each mode on a CNN's params, one client and a stack of 10: the
    corrupted lanes as the reference corrupts them (the noise on the
    right leaves, in the JAX layout), honest lanes untouched."""
    rng = np.random.default_rng(1)
    got_tr = tf.FaultTrace(tf.FAULT_PROFILES[profile], 10, seed=4)
    want_tr = jf.FaultTrace(jf.FAULT_PROFILES[profile], 10, seed=4)
    base = _cnn_tree(rng)
    trees = [_cnn_tree(rng) for _ in range(10)]
    tbase = params_from_jax("cnn", base, device="cpu")
    cids, ords = np.arange(10), rng.integers(0, 6, 10)

    def port(tree):
        return params_from_jax("cnn", jax.tree.map(np.asarray, tree),
                               device="cpu")

    for cid in range(10):
        tree = port(trees[cid])
        got, hit = tf.corrupt_update(tree, tbase, cid, int(ords[cid]),
                                     got_tr, LAYOUTS)
        want, whit = jf.corrupt_update(jax.tree.map(jnp.asarray,
                                                    trees[cid]),
                                       base, cid, int(ords[cid]), want_tr)
        assert hit == whit == bool(got_tr.byzantine[cid])
        if not hit:
            assert got is tree
        for k, v in port(want).items():
            assert torch.equal(got[k], v), (cid, k)
    stack = tagg.stack_params([port(t) for t in trees])
    keep = {k: v.clone() for k, v in stack.items()}
    got, n = tf.corrupt_stacked(stack, tbase, cids, ords, got_tr, LAYOUTS)
    want, wn = jf.corrupt_stacked(jagg.stack_params(trees), base, cids,
                                  ords, want_tr)
    assert n == wn == int(got_tr.byzantine.sum())
    assert n > 0 or profile == "none"
    for i in range(10):
        lane = port(jax.tree.map(lambda x: x[i], want))
        for k in stack:
            if got_tr.byzantine[i]:
                np.testing.assert_allclose(got[k][i].numpy(),
                                           lane[k].numpy(), rtol=0,
                                           atol=1e-6, err_msg=k)
            else:
                assert torch.equal(got[k][i], stack[k][i]), (k, i)
    for k in stack:
        assert torch.equal(stack[k], keep[k])   # the input is not changed


# ---------------------------------------------------------------------------
# every profile through every runtime
# ---------------------------------------------------------------------------

M = 30
CAPS = (1.0, 0.3, 0.8, 1.2, 0.25, 0.9)
SYNC = dict(rounds=3, clients_per_round=4, epochs=3, batch_size=8, lr=0.05,
            seed=2, straggler_pct=40.0)
ASYNC = dict(max_updates=8, concurrency=3, epochs=3, batch_size=8, lr=0.05,
             straggler_pct=40.0, record_every=3, seed=2)


def _clients():
    return [{k: v[:M] for k, v in d.items()}
            for d in synthetic_dataset(0.5, 0.5, n_clients=len(CAPS),
                                       mean_samples=3 * M, std_samples=1,
                                       seed=1)]


def _init():
    jp = jax.tree.map(np.asarray, jsmall.LogisticRegression().init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    return {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in jp.items()}


def _fault_metrics(snapshot):
    both = dict(snapshot["counters"], **snapshot["gauges"])
    return {k: v for k, v in both.items() if k in FAULT_METRICS}


def _recorders():
    return Recorder([InMemorySink()]), JRecorder([JInMemorySink()])


def check_run(out, jout, rec, jrec, model="logreg", params=True):
    assert out["faults"] == jout["faults"]
    assert out["aggregator"] == jout["aggregator"]
    assert len(out["history"]) == len(jout["history"])
    for a, b in zip(out["history"], jout["history"]):
        assert (a.sim_round_time, a.client_times, a.n_participants,
                a.n_dropped, a.n_coreset, a.n_violations) == \
            (b.sim_round_time, b.client_times, b.n_participants,
             b.n_dropped, b.n_coreset, b.n_violations)
    assert _fault_metrics(rec.metrics.snapshot()) == \
        _fault_metrics(jrec.metrics.snapshot())
    want = params_from_jax(model, jax.tree.map(np.asarray, jout["params"]),
                           device="cpu")
    for k, v in (want.items() if params else ()):
        np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                   atol=ATOL, rtol=0, err_msg=k)
    counters = rec.metrics.snapshot()["counters"]
    dropped = counters.get("faults.dropped_updates", 0)
    corrupted = counters.get("faults.corrupted_updates", 0)
    profile = tf.FAULT_PROFILES[out["faults"]]
    # an axis that is off injects nothing; a profile of one axis shows it
    assert not (dropped and not profile.has_dropout)
    assert not (corrupted and not profile.has_corruption)
    if profile.name in ("dropout", "byzantine_signflip", "byzantine_noise",
                        "byzantine_boost"):
        assert dropped + corrupted > 0


@pytest.mark.parametrize("profile", PROFILES)
def test_sync_server_under_faults_matches_reference(profile):
    tm, jm = tsmall.LogisticRegression(), jsmall.LogisticRegression()
    train, jp = _clients(), _init()
    agg = AGGREGATOR[profile]
    rec, jrec = _recorders()
    with j_use_recorder(jrec):
        jout = j_run_federated(
            jm, train, [JClientSpec(i, M, c) for i, c in enumerate(CAPS)],
            jstrat.FedCore(jstrat.LocalTrainer(jm, 0.05, 8)),
            JFLConfig(**SYNC), init_params=jp, aggregator=agg,
            faults=profile)
    with use_recorder(rec):
        out = run_federated(
            tm, train, [ClientSpec(i, M, c) for i, c in enumerate(CAPS)],
            FedCore(LocalTrainer(tm, 0.05, 8, device="cpu")),
            FLConfig(**SYNC), init_params=params_from_jax("logreg", jp,
                                                          device="cpu"),
            aggregator=agg, faults=profile, device="cpu")
    check_run(out, jout, rec, jrec)


@pytest.mark.parametrize("profile", PROFILES)
def test_async_runtime_under_faults_matches_reference(profile):
    """Dispatch masked by churn, mid-flight dropout after the dispatch
    was accounted, corruption against the dispatch snapshot: the event
    log byte for byte and the counters as the reference's."""
    tm, jm = tsmall.LogisticRegression(), jsmall.LogisticRegression()
    train, jp = _clients(), _init()
    agg = AGGREGATOR[profile]

    def aggregator(mod):
        if agg == "weighted_mean":
            return mod.FedBuff(buffer_size=3)
        return mod.RobustAggregate(agg, round_size=3)

    rec, jrec = _recorders()
    with j_use_recorder(jrec):
        jout = j_run_federated_async(
            jm, train, [JClientSpec(i, M, c) for i, c in enumerate(CAPS)],
            jstrat.FedCore(jstrat.LocalTrainer(jm, 0.05, 8)),
            JAsyncFLConfig(**ASYNC), aggregator=aggregator(jagg),
            init_params=jp, faults=profile)
    with use_recorder(rec):
        out = run_federated_async(
            tm, train, [ClientSpec(i, M, c) for i, c in enumerate(CAPS)],
            FedCore(LocalTrainer(tm, 0.05, 8, device="cpu")),
            AsyncFLConfig(**ASYNC), aggregator=aggregator(tagg),
            init_params=params_from_jax("logreg", jp, device="cpu"),
            faults=profile, device="cpu")
    assert out["event_log"] == jout["event_log"]
    assert out["telemetry"]["n_dropped"] == jout["telemetry"]["n_dropped"]
    check_run(out, jout, rec, jrec)


_fleet_cache = {}


def _fleet_bundle():
    if not _fleet_cache:
        jwl = jw.get_workload("mlp")
        clients = jwl.make_clients(n_clients=6, seed=0, mean_samples=24.0,
                                   std_samples=8.0)
        train, test = train_test_split_clients(clients, test_frac=0.1)
        specs = make_client_specs([len(d["y"]) for d in train],
                                  np.random.default_rng(0))
        jp = jax.tree.map(np.asarray, jwl.init(jax.random.PRNGKey(0)))
        _fleet_cache["b"] = (jwl, train, test, specs, jp)
    return _fleet_cache["b"]


def _recording_stats(monkeypatch, module):
    rounds = []
    inner = module.run_fleet_round

    def run_fleet_round(*args, **kwargs):
        params, stats = inner(*args, **kwargs)
        rounds.append(stats)
        return params, stats

    monkeypatch.setattr(module, "run_fleet_round", run_fleet_round)
    return rounds


FLEET = dict(epochs=2, batch_size=8, lr=0.05, seed=0)


def _fleet_reference(profile, monkeypatch):
    key = ("ref", profile)
    if key not in _fleet_cache:
        jwl, train, test, specs, jp = _fleet_bundle()
        jrec = JRecorder([JInMemorySink()])
        with monkeypatch.context() as mp, j_use_recorder(jrec):
            stats = _recording_stats(mp, jb)
            out = jb.run_fleet(
                jwl, train, specs,
                jb.FleetConfig(aggregator=AGGREGATOR[profile], **FLEET), 2,
                straggler_pct=40.0, test_data=test, init_params=jp,
                engine="loop", faults=profile)
        _fleet_cache[key] = (out, stats, jrec)
    return _fleet_cache[key]


@pytest.mark.parametrize("engine", ["batched", "loop"])
@pytest.mark.parametrize("profile", PROFILES)
def test_fleet_under_faults_matches_reference(profile, engine, monkeypatch):
    """Zero weight for dropped lanes, corrupted Byzantine lanes and the
    robust rule over the surviving stacks: each client's dropped and
    corrupted flags and the medoids as the reference's."""
    jout, jstats, jrec = _fleet_reference(profile, monkeypatch)
    _, train, test, specs, jp = _fleet_bundle()
    stats = _recording_stats(monkeypatch, tb)
    rec = Recorder([InMemorySink()])
    with use_recorder(rec):
        out = run_fleet(
            get_workload("mlp"), train,
            [ClientSpec(s.cid, s.m, s.c) for s in specs],
            FleetConfig(aggregator=AGGREGATOR[profile], **FLEET), 2,
            straggler_pct=40.0, test_data=test,
            init_params=params_from_jax("mlp", jp, device="cpu"),
            engine=engine, faults=profile, device="cpu")
    assert sum(h.n_coreset for h in out["history"]) > 0
    assert len(stats) == len(jstats) == 2
    for got, want in zip(stats, jstats):
        for field in ("cids", "dropped", "corrupted", "budgets", "work"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field),
                                          err_msg=field)
        assert set(got.medoids) == set(want.medoids)
        for c in want.medoids:
            np.testing.assert_array_equal(got.medoids[c],
                                          np.asarray(want.medoids[c]))
    check_run(out, jout, rec, jrec, model="mlp")


def _port_workload(name):
    """The port's workload on the JAX init (``PRNGKey(seed)``), converted."""
    jp = jax.tree.map(np.asarray,
                      jw.get_workload(name).init(jax.random.PRNGKey(0)))
    tp = params_from_jax(name, jp, device="cpu")
    wl = get_workload(name)
    wl.model.init = lambda generator, device=None: {
        k: v.clone() for k, v in tp.items()}
    return wl


SCENARIO_RUNTIME = {p: ("sync", "async", "fleet")[i % 3]
                    for i, p in enumerate(PROFILES)}


@pytest.mark.parametrize("profile", PROFILES)
def test_run_scenario_under_faults_matches_reference(profile, monkeypatch):
    """``run_scenario`` on the ``mlp`` workload, the runtimes taken in
    turn: label skew repartitions the data before the specs are built,
    and the robust name reaches the runtime (a buffered
    ``RobustAggregate`` on the async one).

    Label skew refills a client from drained class pools with
    replacement, so a client can hold the same sample twice, and then
    two coresets tie exactly: under ``label_skew`` (sync) client 5's
    first straggler selection (k = 85 of 88 rows, 57 distinct) picks
    another coreset than XLA's with float64 objectives equal
    (1.0350379896563572e-05).  A FedCore run is therefore held as the
    tied fleet cells of ``tests/test_torch_scenarios.py`` are: every
    selection equal up to the first that differs, that one equal in its
    float64 k-medoids objective on the port's features (1e-9 relative),
    the timing, participation and fault fields exact throughout, and the
    parameters compared only when no selection differed."""
    runtime = SCENARIO_RUNTIME[profile]
    selected = {"port": [], "ref": []}
    if runtime != "fleet":
        build, select = jstrat.build_coreset, tstrat.FedCore.select_coreset

        def ref_build(feats, budget, **kwargs):
            cs = build(feats, budget, **kwargs)
            selected["ref"].append(np.asarray(cs.indices))
            return cs

        def port_select(self, feats, budget):
            cs = select(self, feats, budget)
            selected["port"].append((feats.double().numpy(),
                                     cs.indices.numpy()))
            return cs

        monkeypatch.setattr(jstrat, "build_coreset", ref_build)
        monkeypatch.setattr(tstrat.FedCore, "select_coreset", port_select)
    kw = dict(seed=0, rounds=2, clients_per_round=4, epochs=2,
              batch_size=8, lr=0.05, straggler_pct=30.0, n_clients=8,
              faults=profile, aggregator=AGGREGATOR[profile])
    if runtime == "async" and kw["aggregator"] == "weighted_mean":
        kw["aggregator"] = "fedbuff"
    rec, jrec = _recorders()
    with j_use_recorder(jrec):
        jout = js.run_scenario("uniform", runtime, workload="mlp",
                               fleet_engine="loop", **kw)
    with use_recorder(rec):
        out = run_scenario("uniform", runtime,
                           workload=_port_workload("mlp"), device="cpu",
                           **kw)
    assert (out["scenario"], out["runtime"], out["workload"]) == \
        (jout["scenario"], jout["runtime"], jout["workload"])
    assert out["deadline"] == jout["deadline"]
    if runtime == "async":
        assert out["event_log"] == jout["event_log"]
    assert len(selected["port"]) == len(selected["ref"])
    tie = next((i for i, ((_, got), want) in enumerate(
        zip(selected["port"], selected["ref"]))
        if not np.array_equal(got, want)), None)
    if tie is not None:
        feats, got = selected["port"][tie]
        np.testing.assert_allclose(
            medoid_objective_f64(feats, got),
            medoid_objective_f64(feats, selected["ref"][tie]), rtol=1e-9)
    check_run(out, jout, rec, jrec, model="mlp", params=tie is None)
