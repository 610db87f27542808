"""The slice as a whole: the port's fleet engine against the JAX one.

For each ported workload (mlp, cnn, charlm) a 2-round ``run_fleet`` runs
in both of the port's engines (``batched``, ``loop``) and is held against
the JAX package's ``run_fleet(engine="loop")`` on the same client data,
the same converted initial weights and the same seed: the ``RoundRecord``
timing and violation fields must be exact, the coreset medoids equal per
(round, client), and the final parameters within the reference's
conformance tolerance (``PARAMS_ATOL`` of
``tests/test_workload_conformance.py``: 2e-4 for the CNN, 1e-5
otherwise).  The fleet is the reference conformance matrix's (6 clients,
mean 24, std 8, E = 2, B = 8, 40 % stragglers), with coreset budgets
k = 4 and 16.  The CNN's fleet draws its capabilities from another seed,
which gives budgets k = 1 and 4: SmallCNN's gradient features at
initialisation hold near-ties (PERF.md §6), and at k = 16 of m ≈ 20
XLA's and PyTorch's float32 roundings pick the same coreset in another
slot order, or after a round of training another, equally good one.
The budgets chosen leave no near-tied medoid choice.  The default cutover
(``materialize_below=256``) puts these small groups on the batched
pairwise kernel; ``materialize_below=0`` runs them through the
distance-free kernels.

Also here: the cohort grouping, the nominal budgets and the adaptive
scheduler's select / budget sequences, which must equal the reference's
exactly, the port's JSONL passing the reference's schema, a fault
profile and a robust aggregator against the reference, the sharded
engine running batched without a process group, and the checkpoint
arguments at work.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import repro.fed.fleet.batched as jb  # noqa: E402
from repro.data.partition import train_test_split_clients  # noqa: E402
from repro.fed.fleet import scheduler as jsched  # noqa: E402
from repro.fed.fleet import workloads as jw  # noqa: E402
from repro.fed.simulator import make_client_specs  # noqa: E402
from repro.obs.schema import validate_records  # noqa: E402
import repro_torch.fed.fleet.batched as tb  # noqa: E402
from repro_torch.checkpoint import latest_checkpoint  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fed.fleet import (  # noqa: E402
    AdaptiveParticipation, AsyncFleetConfig, FleetConfig,
    ParticipationConfig, get_workload, make_cohort_groups, nominal_budgets,
    run_async_fleet, run_fleet)
from repro_torch.fed.simulator import (ClientSpec,  # noqa: E402
                                       straggler_deadline)
from repro_torch.obs import (InMemorySink, Recorder,  # noqa: E402
                             use_recorder)

torch.set_num_threads(1)

PARAMS_ATOL = {"cnn": 2e-4}
N_CLIENTS, MEAN_M, STD_M = 6, 24.0, 8.0
CFG = dict(epochs=2, batch_size=8, lr=0.05, seed=0)
STRAGGLER_PCT = 40.0
ROUNDS = 2
# capability seed of each workload's fleet, and the coreset budgets it
# gives (see the module docstring for the CNN's)
SPEC_SEED = {"cnn": 2}
BUDGETS = {"cnn": {1, 4}}

_cache = {}


def _bundle(workload):
    """Client data (the reference's bytes), specs and JAX init weights."""
    if workload not in _cache:
        jwl = jw.get_workload(workload)
        clients = jwl.make_clients(n_clients=N_CLIENTS, seed=0,
                                   mean_samples=MEAN_M, std_samples=STD_M)
        train, test = train_test_split_clients(clients, test_frac=0.1)
        specs = make_client_specs(
            [len(d["y"]) for d in train],
            np.random.default_rng(SPEC_SEED.get(workload, 0)))
        jp = jax.tree.map(np.asarray, jwl.init(jax.random.PRNGKey(0)))
        _cache[workload] = (jwl, train, test, specs, jp)
    return _cache[workload]


def _recording(monkeypatch, module):
    """Record each round's medoids {cid: indices} of ``module``'s
    ``run_fleet``."""
    rounds = []
    inner = module.run_fleet_round

    def run_fleet_round(*args, **kwargs):
        params, stats = inner(*args, **kwargs)
        rounds.append({c: np.asarray(m) for c, m in stats.medoids.items()})
        return params, stats

    monkeypatch.setattr(module, "run_fleet_round", run_fleet_round)
    return rounds


def _reference(workload, materialize_below, monkeypatch):
    key = ("ref", workload, materialize_below)
    if key not in _cache:
        jwl, train, test, specs, jp = _bundle(workload)
        with monkeypatch.context() as mp:
            medoids = _recording(mp, jb)
            out = jb.run_fleet(
                jwl, train, specs,
                jb.FleetConfig(materialize_below=materialize_below, **CFG),
                ROUNDS, straggler_pct=STRAGGLER_PCT, test_data=test,
                init_params=jp, engine="loop")
        _cache[key] = (out, medoids)
    return _cache[key]


@pytest.mark.parametrize("engine", ["batched", "loop"])
@pytest.mark.parametrize("workload,materialize_below",
                         [("mlp", 256), ("cnn", 256), ("charlm", 256),
                          ("cnn", 0)])
def test_run_fleet_matches_reference(workload, materialize_below, engine,
                                     monkeypatch):
    jout, j_medoids = _reference(workload, materialize_below, monkeypatch)
    _, train, test, specs, jp = _bundle(workload)
    medoids = _recording(monkeypatch, tb)
    out = run_fleet(
        get_workload(workload), train,
        [ClientSpec(s.cid, s.m, s.c) for s in specs],
        FleetConfig(materialize_below=materialize_below, **CFG), ROUNDS,
        straggler_pct=STRAGGLER_PCT, test_data=test,
        init_params=params_from_jax(workload, jp, device="cpu"),
        engine=engine, device="cpu")

    # the straggler (coreset) path and the full-set path both ran
    assert all(0 < h.n_coreset < h.n_participants for h in out["history"])
    assert {len(m) for r in medoids for m in r.values()} == \
        BUDGETS.get(workload, {4, 16})
    assert out["deadline"] == jout["deadline"]
    for a, b in zip(out["history"], jout["history"]):
        assert a.sim_round_time == b.sim_round_time
        assert a.client_times == b.client_times
        assert (a.n_participants, a.n_dropped, a.n_coreset,
                a.n_violations) == (b.n_participants, b.n_dropped,
                                    b.n_coreset, b.n_violations)
        np.testing.assert_allclose(a.train_loss, b.train_loss, atol=1e-5)
        np.testing.assert_allclose(a.test_acc, b.test_acc, atol=1e-5)
    assert len(medoids) == len(j_medoids) == ROUNDS
    for got, want in zip(medoids, j_medoids):
        assert set(got) == set(want)
        for cid in want:
            np.testing.assert_array_equal(got[cid], want[cid],
                                          err_msg=f"client {cid}")
    want = params_from_jax(workload,
                           jax.tree.map(np.asarray, jout["params"]),
                           device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                   atol=PARAMS_ATOL.get(workload, 1e-5),
                                   err_msg=k)


def test_faults_none_matches_reference():
    """``faults="none"`` runs the fleet as ``faults=None`` does: the same
    run as the reference loop engine's under ``"none"``, and bit for bit
    the port's under None."""
    jwl, train, test, specs, jp = _bundle("mlp")
    jout = jb.run_fleet(jwl, train, specs, jb.FleetConfig(**CFG), ROUNDS,
                        straggler_pct=STRAGGLER_PCT, init_params=jp,
                        engine="loop", faults="none")
    outs = {}
    for faults in ("none", None):
        outs[faults] = run_fleet(
            get_workload("mlp"), train,
            [ClientSpec(s.cid, s.m, s.c) for s in specs],
            FleetConfig(**CFG), ROUNDS, straggler_pct=STRAGGLER_PCT,
            init_params=params_from_jax("mlp", jp, device="cpu"),
            faults=faults, device="cpu")
    out = outs["none"]
    assert out["faults"] == jout["faults"] == "none"
    assert all(h.n_coreset > 0 for h in out["history"])
    for a, b, c in zip(out["history"], jout["history"],
                       outs[None]["history"]):
        assert (a.sim_round_time, a.client_times, a.n_participants,
                a.n_dropped, a.n_coreset) == \
            (b.sim_round_time, b.client_times, b.n_participants,
             b.n_dropped, b.n_coreset)
        np.testing.assert_allclose(a.train_loss, b.train_loss, atol=1e-5)
        assert a.train_loss == c.train_loss
    want = params_from_jax("mlp", jax.tree.map(np.asarray, jout["params"]),
                           device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)
        assert torch.equal(out["params"][k], outs[None]["params"][k])


@pytest.mark.parametrize("workload", ["mlp", "cnn", "charlm"])
def test_cohort_groups_and_budgets_equal_reference(workload):
    _, train, _, specs, _ = _bundle(workload)
    cfg = FleetConfig(**CFG)
    deadline = straggler_deadline(
        [ClientSpec(s.cid, s.m, s.c) for s in specs], cfg.epochs,
        STRAGGLER_PCT)
    budgets = nominal_budgets(specs, deadline, cfg.epochs)
    assert budgets == jb.nominal_budgets(specs, deadline, cfg.epochs)
    cids = list(range(len(train)))
    want = jb.make_cohort_groups(train, cids, budgets, jb.FleetConfig(**CFG),
                                 round_seed=3)
    got = make_cohort_groups(train, cids, budgets, cfg, round_seed=3)
    assert [(g.k, g.valid.shape) for g in got] == \
        [(g.k, g.valid.shape) for g in want]
    assert any(g.k > 0 for g in got) and any(g.k == 0 for g in got)
    for g, w in zip(got, want):
        for name in ("cids", "valid", "m", "perms"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        assert set(g.data) == set(w.data)
        for f in w.data:
            np.testing.assert_array_equal(g.data[f], w.data[f])


def test_scheduler_sequences_equal_reference():
    """Select / budget / observe / record_round over 8 rounds, with a
    loss that plateaus so the cohort grows: the same cohorts, budgets and
    state as the reference's scheduler."""
    rng = np.random.default_rng(4)
    sizes = rng.integers(20, 200, size=40)
    specs = make_client_specs(sizes, np.random.default_rng(1))
    cfg = dict(min_cohort=4, explore_frac=0.25, seed=3)
    want = jsched.AdaptiveParticipation(specs, jsched.ParticipationConfig(
        **cfg))
    got = AdaptiveParticipation([ClientSpec(s.cid, s.m, s.c) for s in specs],
                                ParticipationConfig(**cfg))
    losses = [2.0, 1.5, 1.49, 1.2, 1.19, 1.19, 0.9, 0.89]
    deadline = 150.0
    for r, loss in enumerate(losses):
        cohort = got.select()
        np.testing.assert_array_equal(cohort, want.select())
        for cid in cohort:
            assert got.budget(int(cid), deadline, 5) == \
                want.budget(int(cid), deadline, 5)
            work, dur = float(sizes[cid] * (r + 1)), 1.0 + 0.1 * cid
            got.observe(int(cid), work, dur)
            want.observe(int(cid), work, dur)
        got.record_round(loss)
        want.record_round(loss)
        assert got.summary() == want.summary()
    assert got.growth_log and got.growth_log == want.growth_log
    np.testing.assert_array_equal(got.eligible_mask(), want.eligible_mask())
    assert got.state_dict() == want.state_dict()


def test_port_fleet_jsonl_passes_reference_schema():
    _, train, test, specs, jp = _bundle("mlp")
    sink = InMemorySink()
    with use_recorder(Recorder([sink])):
        out = run_fleet(get_workload("mlp"), train,
                        [ClientSpec(s.cid, s.m, s.c) for s in specs],
                        FleetConfig(**CFG), 1, straggler_pct=STRAGGLER_PCT,
                        test_data=test,
                        init_params=params_from_jax("mlp", jp, device="cpu"),
                        device="cpu")
    validate_records(sink.records)
    spans = {r["name"] for r in sink.records if r["kind"] == "span"}
    assert {"round", "cohort_select", "cohort_build", "local_sgd",
            "coreset_group", "grad_features", "selection", "aggregate",
            "gather", "trace_account", "eval"} <= spans
    rounds = [r for r in sink.records
              if r["kind"] == "event" and r["name"] == "round"]
    assert [r["data"]["n_coreset"] for r in rounds] == \
        [h.n_coreset for h in out["history"]]


def test_not_ported_arguments_raise(tmp_path):
    """``engine="sharded"`` without a process group runs the batched
    engine and says so (``engine_mode``); the checkpoint arguments work:
    a checkpoint file appears and ``resume`` continues from it; unknown
    engines and aggregators raise."""
    _, train, _, specs, _ = _bundle("mlp")
    wl = get_workload("mlp")
    tspecs = [ClientSpec(s.cid, s.m, s.c) for s in specs]
    cfg = FleetConfig(**CFG)

    def run(cfg=cfg, rounds=1, **kwargs):
        return run_fleet(wl, train, tspecs, cfg, rounds, device="cpu",
                         **kwargs)

    sharded, batched = run(engine="sharded"), run()
    assert (sharded["engine"], sharded["engine_mode"]) == ("sharded",
                                                           "batched")
    assert sharded["history"] == batched["history"]
    d = str(tmp_path / "fleet")
    run(checkpoint_dir=d, checkpoint_every=1)
    assert latest_checkpoint(d).endswith("ckpt_000000.npz")
    assert [h.round for h in run(checkpoint_every=1)["history"]] == [0]
    assert [h.round for h in run(resume=True)["history"]] == [0]
    resumed = run(rounds=2, checkpoint_dir=d, resume=True)
    assert [h.round for h in resumed["history"]] == [0, 1]
    with pytest.raises(ValueError, match="unknown fleet engine"):
        run(engine="async")
    with pytest.raises(ValueError, match="unknown fleet aggregator"):
        run(cfg=FleetConfig(aggregator="mean", **CFG))

    def run_async(max_updates=1, **kwargs):
        return run_async_fleet(
            wl, train, tspecs,
            AsyncFleetConfig(max_updates=max_updates, buffer_k=2,
                             concurrency=3, epochs=1),
            device="cpu", **kwargs)

    sharded, batched = run_async(engine="sharded"), run_async()
    assert sharded["engine_mode"] == "batched"
    assert sharded["event_log"] == batched["event_log"]
    d = str(tmp_path / "async_fleet")
    run_async(checkpoint_dir=d, checkpoint_every=1)
    assert latest_checkpoint(d).endswith("ckpt_000001.npz")
    assert run_async(checkpoint_every=1)["applied"] == 1
    assert run_async(resume=True)["applied"] == 1
    resumed = run_async(max_updates=2, checkpoint_dir=d, resume=True)
    assert resumed["applied"] == 2
    assert [h.round for h in resumed["history"]] == [0, 1]
    with pytest.raises(ValueError, match="unknown async fleet engine"):
        run_async(engine="async")
    with pytest.raises(ValueError, match="at least one client"):
        run_async_fleet(wl, [], [], AsyncFleetConfig(), device="cpu")
    assert get_workload("translm").name == "translm"
    with pytest.raises(ValueError, match="unknown fleet workload"):
        get_workload("resnet")


@pytest.mark.parametrize("faults,aggregator", [("dropout", "weighted_mean"),
                                               (None, "median")])
@pytest.mark.parametrize("engine", ["batched", "loop"])
def test_faults_and_robust_aggregator_match_reference(engine, faults,
                                                      aggregator):
    """``faults="dropout"`` and ``aggregator="median"`` on the mlp fleet:
    each client's dropped flag, the timing fields and the parameters as
    the reference's loop engine gives them."""
    jwl, train, test, specs, jp = _bundle("mlp")
    cfg = dict(CFG, aggregator=aggregator)
    jout = jb.run_fleet(jwl, train, specs, jb.FleetConfig(**cfg), ROUNDS,
                        straggler_pct=STRAGGLER_PCT, test_data=test,
                        init_params=jp, engine="loop", faults=faults)
    out = run_fleet(get_workload("mlp"), train,
                    [ClientSpec(s.cid, s.m, s.c) for s in specs],
                    FleetConfig(**cfg), ROUNDS, straggler_pct=STRAGGLER_PCT,
                    test_data=test,
                    init_params=params_from_jax("mlp", jp, device="cpu"),
                    engine=engine, faults=faults, device="cpu")
    assert (out["faults"], out["aggregator"]) == \
        (jout["faults"], jout["aggregator"])
    for a, b in zip(out["history"], jout["history"]):
        assert (a.sim_round_time, a.client_times, a.n_dropped,
                a.n_coreset, a.n_participants) == \
            (b.sim_round_time, b.client_times, b.n_dropped, b.n_coreset,
             b.n_participants)
    assert (sum(h.n_dropped for h in out["history"]) > 0) == \
        (faults == "dropout")
    want = params_from_jax("mlp", jax.tree.map(np.asarray, jout["params"]),
                           device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)


def test_workload_schema_and_client_bytes_equal_reference():
    for name in ("mlp", "cnn", "charlm", "xlstm", "translm"):
        jwl, wl = jw.get_workload(name), get_workload(name)
        assert {k: (s.shape, s.dtype) for k, s in wl.schema.items()} == \
            {k: (s.shape, s.dtype) for k, s in jwl.schema.items()}
        kw = dict(n_clients=4, seed=2, mean_samples=30.0, std_samples=10.0)
        got, want = wl.make_clients(**kw), jwl.make_clients(**kw)
        wl.validate_clients(got)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for f in w:
                assert g[f].dtype == w[f].dtype
                assert g[f].tobytes() == w[f].tobytes()
    bad = [{"x": np.zeros((3, 60), np.float64), "y": np.zeros(3, np.int32)}]
    with pytest.raises(ValueError, match="dtype"):
        get_workload("mlp").validate_clients(bad)
