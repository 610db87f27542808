"""The port's own copies of the numpy-only modules give the reference's
bytes: the data generators, partitioning and batching, the simulator
and the cost model."""
import numpy as np
import pytest

pytest.importorskip("jax")

import repro.data as jdata  # noqa: E402
import repro.fed.cost as jcost  # noqa: E402
import repro.fed.simulator as jsim  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.fed.cost as tcost  # noqa: E402
import repro_torch.fed.simulator as tsim  # noqa: E402

GENERATORS = {
    "synthetic": dict(alpha=0.5, beta=0.5, n_clients=5, mean_samples=40,
                      std_samples=30, seed=3),
    "mnist_like": dict(n_clients=4, mean_samples=20, std_samples=10,
                       seed=3),
    "shakespeare_like": dict(n_clients=3, mean_samples=30, std_samples=20,
                             seq_len=16, seed=3),
}
FUNCS = {"synthetic": "synthetic_dataset",
         "mnist_like": "mnist_like_dataset",
         "shakespeare_like": "shakespeare_like_dataset"}


def _assert_same_bytes(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_generators_are_byte_identical(gen):
    want = getattr(jdata, FUNCS[gen])(**GENERATORS[gen])
    got = getattr(tdata, FUNCS[gen])(**GENERATORS[gen])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            _assert_same_bytes(g[k], w[k])


def test_partition_and_batching_are_byte_identical():
    clients = jdata.synthetic_dataset(0.5, 0.5, n_clients=4, mean_samples=30,
                                      std_samples=10, seed=2)
    (jtr, jte), (ttr, tte) = (jdata.train_test_split_clients(clients),
                              tdata.train_test_split_clients(clients))
    for k in jte:
        _assert_same_bytes(tte[k], jte[k])
    for a, b in zip(ttr, jtr):
        for k in b:
            _assert_same_bytes(a[k], b[k])
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    for bj, bt in zip(jdata.epoch_batches(jtr[0], 8, rj),
                      tdata.epoch_batches(ttr[0], 8, rt)):
        for k in bj:
            _assert_same_bytes(bt[k], bj[k])
    _assert_same_bytes(
        tdata.power_law_sizes(50, 69.0, 106.0, np.random.default_rng(1)),
        jdata.power_law_sizes(50, 69.0, 106.0, np.random.default_rng(1)))


def test_simulator_and_cost_plans_match():
    sizes = np.random.default_rng(4).integers(10, 400, size=40)
    jspecs = jsim.make_client_specs(sizes, np.random.default_rng(4))
    tspecs = tsim.make_client_specs(sizes, np.random.default_rng(4))
    assert [(s.cid, s.m, s.c) for s in tspecs] == \
        [(s.cid, s.m, s.c) for s in jspecs]
    for cost in (None, 2.5):
        tau_j = jsim.straggler_deadline(jspecs, 5, 30.0, cost)
        tau_t = tsim.straggler_deadline(tspecs, 5, 30.0, cost)
        assert tau_t == tau_j
        jc, tc = jcost.resolve_cost(cost), tcost.resolve_cost(cost)
        for s in tspecs:
            assert tc.needs_coreset(s.m, s.c, tau_t, 5) == \
                jc.needs_coreset(s.m, s.c, tau_j, 5)
            assert tc.budget(s.m, s.c, tau_t, 5) == \
                jc.budget(s.m, s.c, tau_j, 5)
            jp = jc.primary_plan(s.m, s.c, tau_j, 5)
            tp = tc.primary_plan(s.m, s.c, tau_t, 5)
            assert (tp is None) == (jp is None)
            if tp is not None:
                assert dataclasses_tuple(tp) == dataclasses_tuple(jp)
            assert dataclasses_tuple(tc.fallback_plan(s.m, s.c, tau_t, 5)) \
                == dataclasses_tuple(jc.fallback_plan(s.m, s.c, tau_j, 5))
    trace_j = jsim.CapabilityTrace(jsim.TraceConfig(seed=3))
    trace_t = tsim.CapabilityTrace(tsim.TraceConfig(seed=3))
    for s in tspecs[:5]:
        for i in range(4):
            assert trace_t.capability(s, i) == trace_j.capability(s, i)
            assert trace_t.jitter(s, i) == trace_j.jitter(s, i)


def dataclasses_tuple(plan):
    return (plan.budget, plan.eff_epochs, plan.work, plan.violated)
