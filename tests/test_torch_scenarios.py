"""The scenario registry against the JAX package's.

``build_scenario`` must give the JAX package's ``ClientSpec``s (the same
capability bytes) and an equal ``TraceConfig`` for every scenario.
``run_scenario`` drives a scenario through the port's ``sync`` runtime
(``run_federated`` with ``FedCore``) and ``fleet`` runtime (``run_fleet``)
on the ``mlp`` workload here and the ``xlstm`` workload in
``test_torch_scenarios_xlstm.py``, at a small size (8 clients the
workload builds itself, 2 rounds, E = 2), held against the JAX
``run_scenario`` on the same data and initial weights (the JAX init,
converted): the ``RoundRecord`` timing and participation fields exact,
train loss and parameters within 1e-5 (the conformance matrix's
``PARAMS_ATOL`` for both workloads).  The JAX fleet runs its loop engine,
the reference.  The runtimes and arguments not ported yet raise
``NotImplementedError`` naming their ROADMAP items.

The fleet cells avoid the scenarios whose capabilities put a near-tied
medoid choice in front of a straggler: under ``device_classes``,
``flash_crowd`` and ``pareto`` the mlp fleet's client 0 (k = 16 of 43)
gets another coreset from the port than from XLA, with float64 k-medoids
objectives equal to 15 digits (45.94240763618336), and its parameters
drift 1.1e-5 apart; under ``device_classes`` the xlstm fleet meets such a
tie too.  ``uniform`` and ``diurnal`` (mlp) and ``flash_crowd`` (xlstm)
have none.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.fed.fleet import scenarios as js  # noqa: E402
from repro.fed.fleet import scheduler as jsched  # noqa: E402
from repro.fed.fleet import workloads as jw  # noqa: E402
from repro.obs.schema import validate_records  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
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


def check_against_reference(scenario, runtime, workload, engine=None):
    """``run_scenario`` of the port (``engine`` for the fleet runtime)
    against the JAX package's (its loop engine for the fleet runtime),
    as the module docstring says."""
    kw = dict(RUN, fleet_engine=engine or "batched")
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

    for runtime in ("async", "async_fleet"):
        with pytest.raises(NotImplementedError, match="item 11"):
            run(runtime)
    with pytest.raises(NotImplementedError, match="item 12"):
        run(faults="dropout")
    for runtime in ("sync", "fleet"):
        with pytest.raises(NotImplementedError, match="item 12"):
            run(runtime, aggregator="median")
    with pytest.raises(NotImplementedError, match="item 15"):
        run(fleet_engine="sharded")
    with pytest.raises(ValueError, match="unknown runtime"):
        run("batched")
    with pytest.raises(ValueError, match="needs model"):
        run_scenario("uniform", "sync", device="cpu")
