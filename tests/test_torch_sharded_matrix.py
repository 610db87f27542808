"""The sharded fleet engine on two ``gloo`` ranks against the batched
engine, workload by workload.

Each of the port's five fleet workloads (mlp, cnn, charlm, xlstm,
translm) runs ``run_fleet(engine="sharded")`` for 2 rounds on two CPU
ranks (``sharded_ranks``: one spawn for the whole matrix), and
``run_fleet(engine="batched")`` in the test process on the same fleet:
the conformance matrix's 6 clients (mean 24, std 8, E = 2, B = 8, 40 %
stragglers), whose cohort groups of 1 to 3 clients leave odd groups
padded with a zero-weight lane.  The medoids per (round, client) must
be equal, the params within the reference's conformance tolerance
(``PARAMS_ATOL`` of ``tests/test_workload_conformance.py``), the
history's timing fields exact, the dispatch counts equal (one a group),
and the two ranks' params bit-identical.  The CNN and xlstm fleets draw
their capabilities from the seeds the port's fleet tests use (2 and 1):
their default draws give k = 16 of m ≈ 20, where SmallCNN's and the
mLSTM's features hold near-ties that a last-bit change of the params
(the sharded sum's order) can turn into another, equally good coreset.
"""
import numpy as np
import pytest
import torch

import sharded_ranks as sr

torch.set_num_threads(1)

WORKLOADS = ("mlp", "cnn", "charlm", "xlstm", "translm")
PARAMS_ATOL = {"cnn": 2e-4}     # 1e-5 for the others
SPEC_SEED = {"cnn": 2, "xlstm": 1}
CFG = dict(epochs=2, batch_size=8, lr=0.05, seed=0)
ROUNDS = 2


def _case(workload):
    return {"fleet": {"workload": workload,
                      "spec_seed": SPEC_SEED.get(workload, 0)},
            "cfg": CFG, "rounds": ROUNDS}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{workload: [rank 0's run, rank 1's run]}, one spawn for all."""
    ranks = sr.run_ranks(sr.jobs, 2, tmp_path_factory.mktemp("matrix"),
                         [("fleet", _case(w)) for w in WORKLOADS])
    return {w: [r[i] for r in ranks] for i, w in enumerate(WORKLOADS)}


_batched = {}


def _reference(workload):
    if workload not in _batched:
        _batched[workload] = sr.fleet_run(_case(workload), "batched")
    return _batched[workload]


# the (round, client)s where the two engines' coresets are tied (the same
# set in another slot order: BUILD's add-costs near-tie after the
# rounds' aggregates differ in the last bits)
TIES = {"charlm": [(1, 1)]}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_medoids_equal_batched(sharded, workload):
    want = _reference(workload)
    assert any(r["medoids"] for r in want["rounds"])  # stragglers selected
    for got in sharded[workload]:
        assert got["engine_mode"] == "sharded" and got["n_devices"] == 2
        ties = sr.check_medoids(_case(workload)["fleet"], got, want)
        assert ties == TIES.get(workload, [])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_params_and_history_match_batched(sharded, workload):
    want = _reference(workload)
    atol = PARAMS_ATOL.get(workload, 1e-5)
    for got in sharded[workload]:
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=atol, err_msg=k)
        for a, b in zip(got["history"], want["history"]):
            assert a.client_times == b.client_times
            assert (a.n_participants, a.n_coreset, a.n_violations) == \
                (b.n_participants, b.n_coreset, b.n_violations)
            np.testing.assert_allclose(a.train_loss, b.train_loss,
                                       atol=atol)
            np.testing.assert_allclose(a.test_loss, b.test_loss, atol=atol)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_dispatch_counts_equal_batched(sharded, workload):
    """One dispatch a group on every rank, as on the batched engine;
    the weighted mean never gathers a client stack."""
    want = _reference(workload)
    for got in sharded[workload]:
        assert got["dispatches"] == want["dispatches"] > 0
        assert got["stack_gathers"] == 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_ranks_end_on_the_same_bits(sharded, workload):
    a, b = sharded[workload]
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert np.array_equal(a["params"][k], b["params"][k]), k
    assert a["history"] == b["history"]


def test_rank_zero_alone_records(sharded):
    """Rank 0 writes the recorder's sinks, its group spans marked
    ``sharded`` and the collectives in ``allreduce`` spans; rank 1's
    recorder receives nothing."""
    lead, other = sharded["mlp"]
    assert lead["records"][0] == "run" and "allreduce" in lead["spans"]
    assert {"local_sgd", "coreset_group", "round"} <= lead["spans"]
    assert lead["sharded_spans"] > 0
    assert other["records"] == []
