"""The sharded engine on the async fleet, under faults, through the
scenario registry, and across a checkpoint, on two ``gloo`` ranks.

One spawn of two CPU ranks (``sharded_ranks``) runs every case sharded;
the test process runs the batched engine on the same fleets:

  * ``run_async_fleet(engine="sharded")`` with the FedBuff merge on mlp
    and charlm (the reference's ``test_engine_mode_parity``: the event
    log is the batched engine's byte for byte), and with ``hostile``
    faults and the trimmed-mean merge (the flush's client stacks
    gathered to every rank): medoids per (flush, client) equal, params
    within 1e-5, the group dispatch counts equal;
  * ``run_fleet`` under ``hostile`` with the trimmed mean: the stack is
    gathered, every client's dropped and corrupted flags are the batched
    run's, medoids equal, params within 1e-5;
  * ``run_scenario(..., fleet_engine="sharded")`` on the fleet and async
    fleet runtimes;
  * checkpoint and resume (the port's resume test's fleet: mlp, 20
    clients, the adaptive scheduler, dropout): rank 0 alone writes the
    checkpoints, and the resumed run equals the uninterrupted one, byte
    for byte on every rank.

Every case ends with both ranks on the same bits.
"""
import numpy as np
import pytest
import torch

import sharded_ranks as sr

torch.set_num_threads(1)

ASYNC_CFG = dict(max_updates=3, buffer_k=3, concurrency=5, epochs=2,
                 batch_size=8, lr=0.05, straggler_pct=40.0, seed=0)
ASYNC = {
    "mlp": {"fleet": {"workload": "mlp"}, "cfg": ASYNC_CFG},
    "charlm": {"fleet": {"workload": "charlm"}, "cfg": ASYNC_CFG},
    "hostile": {"fleet": {"workload": "mlp"}, "cfg": ASYNC_CFG,
                "faults": "hostile", "aggregator": "trimmed_mean"},
}
FAULTED = {"fleet": {"workload": "mlp"},
           "cfg": dict(epochs=2, batch_size=8, lr=0.05, seed=0,
                       aggregator="trimmed_mean"),
           "rounds": 2, "faults": "hostile"}
SCENARIO = {"fleet": dict(name="device_classes", runtime="fleet",
                          workload="mlp", n_clients=12, rounds=2),
            "async_fleet": dict(name="pareto", runtime="async_fleet",
                                workload="mlp", n_clients=12, rounds=2,
                                clients_per_round=4)}
TELEMETRY = ("makespan", "n_dispatches", "n_updates_applied",
             "n_merged_clients", "n_partial_flushes", "n_violations",
             "n_dropped_updates", "n_corrupted_updates",
             "n_group_dispatches")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{case: [rank 0's result, rank 1's]}, one spawn for all."""
    tmp = tmp_path_factory.mktemp("sharded_async")
    todo = ([("async", c) for c in ASYNC.values()] + [("fleet", FAULTED)]
            + [("scenario", c) for c in SCENARIO.values()]
            + [("resume", {"async": a, "upto": 3, "cut": 1 + a,
                           "dir": str(tmp / f"ckpt_{a}")})
               for a in (False, True)])
    keys = ([f"async:{k}" for k in ASYNC] + ["faulted"]
            + [f"scenario:{k}" for k in SCENARIO]
            + ["resume:fleet", "resume:async_fleet"])
    out = sr.run_ranks(sr.jobs, 2, tmp, todo)
    return {k: [r[i] for r in out] for i, k in enumerate(keys)}


def _same_bits(a, b):
    assert a.keys() == b.keys()
    return all(np.array_equal(a[k], b[k]) for k in a)


def _close(got, want, atol=1e-5):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", sorted(ASYNC))
def test_async_fleet_matches_batched(ranks, case):
    want = sr.async_run(ASYNC[case], "batched")
    assert any(want["medoids"].values())            # a straggler selected
    for got in ranks[f"async:{case}"]:
        assert (got["engine_mode"], got["n_devices"]) == ("sharded", 2)
        assert got["event_log"] == want["event_log"]
        for key in TELEMETRY:
            assert got["telemetry"][key] == want["telemetry"][key], key
        assert got["dispatches"] == want["dispatches"]
        assert sorted(got["medoids"]) == sorted(want["medoids"])
        for flush, meds in want["medoids"].items():
            assert sorted(got["medoids"][flush]) == sorted(meds)
            for cid, med in meds.items():
                np.testing.assert_array_equal(got["medoids"][flush][cid], med)
        _close(got["params"], want["params"])
        for a, b in zip(got["history"], want["history"]):
            assert a.client_times == b.client_times
            assert (a.n_participants, a.n_dropped, a.n_coreset) == \
                (b.n_participants, b.n_dropped, b.n_coreset)
    a, b = ranks[f"async:{case}"]
    assert _same_bits(a["params"], b["params"])
    # only the robust merge needs the flush's client stacks
    assert (a["stack_gathers"] > 0) == (case == "hostile")


def test_faulted_fleet_gathers_the_stack(ranks):
    want = sr.fleet_run(FAULTED, "batched")
    assert sum(r["corrupted"].sum() for r in want["rounds"]) > 0
    assert sum(r["dropped"].sum() for r in want["rounds"]) > 0
    for got in ranks["faulted"]:
        assert got["stack_gathers"] > 0
        for a, b in zip(got["rounds"], want["rounds"]):
            np.testing.assert_array_equal(a["dropped"], b["dropped"])
            np.testing.assert_array_equal(a["corrupted"], b["corrupted"])
        assert sr.check_medoids(FAULTED["fleet"], got, want) == []
        _close(got["params"], want["params"])
    a, b = ranks["faulted"]
    assert _same_bits(a["params"], b["params"])


@pytest.mark.parametrize("runtime", sorted(SCENARIO))
def test_scenario_runtimes_take_the_sharded_engine(ranks, runtime):
    want = sr.scenario_run(SCENARIO[runtime], "batched")
    for got in ranks[f"scenario:{runtime}"]:
        assert got["engine_mode"] == "sharded"
        assert got["event_log"] == want["event_log"]
        assert [h.client_times for h in got["history"]] == \
            [h.client_times for h in want["history"]]
        _close(got["params"], want["params"])
    a, b = ranks[f"scenario:{runtime}"]
    assert _same_bits(a["params"], b["params"])


@pytest.mark.parametrize("runtime", ["fleet", "async_fleet"])
def test_resume_equals_the_uninterrupted_run(ranks, runtime):
    lead, other = ranks[f"resume:{runtime}"]
    assert lead["saved"] and other["saved"] == []   # rank 0 alone writes
    for r in (lead, other):
        full, resumed = r["full"], r["resumed"]
        assert full["engine_mode"] == resumed["engine_mode"] == "sharded"
        assert resumed["history"] == full["history"]
        assert resumed["event_log"] == full["event_log"]
        assert _same_bits(resumed["params"], full["params"])
    assert _same_bits(lead["full"]["params"], other["full"]["params"])
