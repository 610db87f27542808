"""The scenario registry against the JAX package's.

``build_scenario`` must give the JAX package's ``ClientSpec``s (the same
capability bytes) and an equal ``TraceConfig`` for every scenario.
``run_scenario`` drives a scenario through the port's ``sync`` runtime
(``run_federated`` with ``FedCore``), ``async`` runtime
(``run_federated_async`` with ``FedCore``) and ``fleet`` runtime
(``run_fleet``)
on the ``mlp`` workload here and the ``xlstm`` workload in
``test_torch_scenarios_xlstm.py``, at a small size (8 clients the
workload builds itself, 2 rounds, E = 2), held against the JAX
``run_scenario`` on the same data and initial weights (the JAX init,
converted): the ``RoundRecord`` timing and participation fields exact,
train loss and parameters within 1e-5 (the conformance matrix's
``PARAMS_ATOL`` for both workloads).  The JAX fleet runs its loop engine,
the reference; the async runtime's event log must equal the reference's
byte for byte.  Unknown runtimes and arguments raise, and the sharded
fleet engine runs batched without a process group.

Some scenarios' capabilities put a near-tied medoid choice in front of
a straggler: under ``device_classes``, ``flash_crowd`` and ``pareto`` the
mlp fleet's client 0 (k = 16 of 43) gets another coreset from the port
than from XLA, with float64 k-medoids objectives equal to 15 digits
(45.94240763618336), and its parameters drift 1.1e-5 apart; under
``device_classes`` the xlstm fleet meets such a tie too.  Those cells are
held as the North star rule holds tied optima
(``check_tied_against_reference``): the ``RoundRecord`` timing and
participation fields exact, every first-round coreset held by its
float64 k-medoids objective on the port's features (equal within 1e-9
relative) rather than by index, and no parameter or loss compared after
the tie.  ``uniform`` and ``diurnal`` (mlp) and ``flash_crowd`` (xlstm)
have no tie and are held in full.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import repro.fed.fleet.batched as jb  # noqa: E402
from repro.fed.fleet import scenarios as js  # noqa: E402
from repro.fed.fleet import scheduler as jsched  # noqa: E402
from repro.fed.fleet import workloads as jw  # noqa: E402
from repro.obs.schema import validate_records  # noqa: E402
import repro_torch.fed.fleet.batched as tb  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.kmedoids import medoid_objective_f64  # noqa: E402
from repro_torch.fed.fleet import (SCENARIOS, AdaptiveParticipation,  # noqa: E402,E501
                                   ParticipationConfig, build_scenario,
                                   get_workload, run_scenario)
from repro_torch.fed.simulator import ClientSpec  # noqa: E402
from repro_torch.obs import InMemorySink, Recorder, use_recorder  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5
RUN = dict(seed=0, rounds=2, clients_per_round=4, epochs=2, batch_size=8,
           lr=0.05, straggler_pct=30.0, n_clients=8)


@pytest.mark.parametrize("name", sorted(js.SCENARIOS))
def test_build_scenario_equals_reference(name):
    assert dataclasses.asdict(SCENARIOS[name]) == \
        dataclasses.asdict(js.SCENARIOS[name])
    sizes = np.random.default_rng(3).integers(5, 400, size=64)
    for seed in (0, 7):
        specs, trace = build_scenario(name, sizes, seed)
        jspecs, jtrace = js.build_scenario(name, sizes, seed)
        assert [(s.cid, s.m) for s in specs] == \
            [(s.cid, s.m) for s in jspecs]
        assert np.array([s.c for s in specs]).tobytes() == \
            np.array([s.c for s in jspecs]).tobytes()
        assert dataclasses.asdict(trace) == dataclasses.asdict(jtrace)


def _port_workload(name):
    """The port's workload on the JAX init (``PRNGKey(seed)``, the key
    the JAX runtimes draw from), converted."""
    jp = jax.tree.map(np.asarray,
                      jw.get_workload(name).init(jax.random.PRNGKey(0)))
    tp = params_from_jax(name, jp, device="cpu")
    wl = get_workload(name)
    wl.model.init = lambda generator, device=None: {
        k: v.clone() for k, v in tp.items()}
    return wl


def check_against_reference(scenario, runtime, workload, engine=None,
                            **extra):
    """``run_scenario`` of the port (``engine`` for the fleet runtime)
    against the JAX package's (its loop engine for the fleet runtime),
    as the module docstring says; ``extra`` goes to both."""
    kw = dict(RUN, fleet_engine=engine or "batched", **extra)
    jout = js.run_scenario(scenario, runtime, workload=workload,
                           **dict(kw, fleet_engine="loop"))
    sink = InMemorySink()
    with use_recorder(Recorder([sink])):
        out = run_scenario(scenario, runtime,
                           workload=_port_workload(workload), device="cpu",
                           **kw)
    validate_records(sink.records)
    assert sink.records[0]["name"] == "scenario"
    assert sink.records[0]["data"]["workload"] == workload
    for key in ("scenario", "runtime", "workload", "faults"):
        assert out[key] == jout[key]
    assert out.get("event_log") == jout.get("event_log")
    assert out["deadline"] == jout["deadline"]
    # the straggler (coreset) path ran
    assert sum(h.n_coreset for h in out["history"]) > 0
    for a, b in zip(out["history"], jout["history"]):
        assert a.sim_round_time == b.sim_round_time
        assert a.client_times == b.client_times
        assert (a.n_participants, a.n_dropped, a.n_coreset,
                a.n_violations) == (b.n_participants, b.n_dropped,
                                    b.n_coreset, b.n_violations)
        np.testing.assert_allclose(a.train_loss, b.train_loss, atol=ATOL)
    want = params_from_jax(workload,
                           jax.tree.map(np.asarray, jout["params"]),
                           device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("scenario,runtime,engine", [
    ("uniform", "sync", None), ("diurnal", "fleet", "batched"),
    ("uniform", "fleet", "loop")])
def test_run_scenario_matches_reference(scenario, runtime, engine):
    check_against_reference(scenario, runtime, "mlp", engine)


def check_tied_against_reference(scenario, workload, monkeypatch):
    """A fleet cell with a near-tied medoid choice: the port's batched
    ``run_scenario`` against the JAX package's loop engine, the timing and
    participation fields of every ``RoundRecord`` exact, and each
    straggler's first-round coreset held by its float64 k-medoids
    objective over its features at the round-start parameters (the same
    on both sides; the port's are used), within 1e-9 relative.  The tie
    changes the coresets' training, so no parameter, loss or later
    coreset is compared."""
    def recorder(module):
        rounds = []
        inner = module.run_fleet_round

        def run_fleet_round(*args, **kwargs):
            params, stats = inner(*args, **kwargs)
            rounds.append({int(c): np.asarray(m)
                           for c, m in stats.medoids.items()})
            return params, stats

        monkeypatch.setattr(module, "run_fleet_round", run_fleet_round)
        return rounds

    j_medoids = recorder(jb)
    jout = js.run_scenario(scenario, "fleet", workload=workload,
                           **dict(RUN, fleet_engine="loop"))
    medoids, feats = recorder(tb), {}
    run_group = tb.FleetEngine.run_group

    def recording_group(self, params, group, batched=True):
        seen, select = [], self._select

        def recording_select(f, valid, k):
            seen.append(f)
            return select(f, valid, k)

        self._select = recording_select
        try:
            return run_group(self, params, group, batched)
        finally:
            del self._select
            if seen and not medoids:        # the first round
                f = torch.cat(seen)
                for i, (cid, m) in enumerate(zip(group.cids, group.m)):
                    feats[int(cid)] = f[i, :m].double().numpy()

    monkeypatch.setattr(tb.FleetEngine, "run_group", recording_group)
    out = run_scenario(scenario, "fleet",
                       workload=_port_workload(workload), device="cpu",
                       **dict(RUN, fleet_engine="batched"))
    assert out["deadline"] == jout["deadline"]
    assert sum(h.n_coreset for h in out["history"]) > 0
    for a, b in zip(out["history"], jout["history"]):
        assert a.sim_round_time == b.sim_round_time
        assert a.client_times == b.client_times
        assert (a.n_participants, a.n_dropped, a.n_coreset,
                a.n_violations) == (b.n_participants, b.n_dropped,
                                    b.n_coreset, b.n_violations)
    got, want = medoids[0], j_medoids[0]
    assert got and set(got) == set(want) == set(feats)
    for cid in want:
        assert len(got[cid]) == len(want[cid])
        np.testing.assert_allclose(
            medoid_objective_f64(feats[cid], got[cid]),
            medoid_objective_f64(feats[cid], want[cid]), rtol=1e-9,
            err_msg=f"client {cid}")


@pytest.mark.parametrize("scenario", ["device_classes", "flash_crowd",
                                      "pareto"])
def test_tied_fleet_cell_matches_reference_by_objective(scenario,
                                                        monkeypatch):
    check_tied_against_reference(scenario, "mlp", monkeypatch)


@pytest.mark.parametrize("runtime,engine", [("sync", None),
                                            ("fleet", "batched")])
def test_faults_none_matches_reference(runtime, engine):
    """The reference registry's no-fault profile by name: the same run
    as the reference's under ``faults="none"``."""
    check_against_reference("uniform", runtime, "mlp", engine,
                            faults="none")


def test_sync_scenario_with_adaptive_participation_matches_reference():
    """The sync server's scheduler hooks: the same cohorts, durations and
    scheduler state as the reference's."""
    clients = jw.get_workload("mlp").make_clients(n_clients=12, seed=0)
    sizes = [len(d["y"]) for d in clients]
    jspecs, _ = js.build_scenario("diurnal", sizes, 0)
    cfg = dict(min_cohort=4, explore_frac=0.25, seed=3)
    jsch = jsched.AdaptiveParticipation(jspecs,
                                        jsched.ParticipationConfig(**cfg))
    tsch = AdaptiveParticipation([ClientSpec(s.cid, s.m, s.c)
                                  for s in jspecs],
                                 ParticipationConfig(**cfg))
    kw = dict(RUN, rounds=3)
    del kw["n_clients"]
    jout = js.run_scenario("diurnal", "sync", workload="mlp",
                           clients_data=clients, scheduler=jsch, **kw)
    out = run_scenario("diurnal", "sync", workload="mlp",
                       clients_data=clients, scheduler=tsch, device="cpu",
                       **kw)
    for a, b in zip(out["history"], jout["history"]):
        assert a.client_times == b.client_times
        assert (a.n_participants, a.n_coreset) == \
            (b.n_participants, b.n_coreset)
        np.testing.assert_allclose(a.train_loss, b.train_loss, atol=ATOL)
    assert tsch.summary() == jsch.summary()
    # the scheduler keeps the best train loss, a float32 training result
    got, want = tsch.state_dict(), jsch.state_dict()
    np.testing.assert_allclose(got.pop("best_loss"), want.pop("best_loss"),
                               atol=ATOL)
    assert got == want


def test_not_ported_arguments_raise():
    def run(runtime="fleet", **kwargs):
        return run_scenario("uniform", runtime, workload="mlp", n_clients=4,
                            rounds=1, device="cpu", **kwargs)

    # without a process group the sharded engine runs batched
    assert run("async_fleet",
               fleet_engine="sharded")["engine_mode"] == "batched"
    with pytest.raises(ValueError, match="unknown async fleet engine"):
        run("async_fleet", fleet_engine="async")
    assert run(fleet_engine="sharded")["engine_mode"] == "batched"
    with pytest.raises(ValueError, match="unknown runtime"):
        run("batched")
    with pytest.raises(ValueError, match="needs model"):
        run_scenario("uniform", "sync", device="cpu")
    with pytest.raises(ValueError, match="unknown fault profile"):
        run(faults="meteor")


@pytest.mark.parametrize("runtime,engine,extra", [
    ("async", None, {}),
    ("async", None, {"aggregator": "delayed_grad", "max_updates": 10}),
    ("sync", None, {"faults": "dropout"}),
    ("sync", None, {"aggregator": "median"}),
    ("fleet", "batched", {"aggregator": "median"})])
def test_async_runtime_faults_and_robust_rules_match_reference(
        runtime, engine, extra):
    """The async runtime (the reference's default FedAsync, and delayed
    gradients), a fault profile and a robust aggregator by name: the run
    as the reference's, the async event log byte for byte."""
    check_against_reference("uniform", runtime, "mlp", engine, **extra)
