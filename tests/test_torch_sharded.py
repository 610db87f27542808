"""The sharded fleet engine against the JAX package's, and on one rank.

The reference's own case (``tests/test_fleet_sharded.py``): the mlp
workload, 18 clients (seed 3, ``device_classes`` capabilities), E = 3,
B = 16, lr 0.05, 40 % stragglers, one ``run_fleet_round`` from the JAX
init.  The JAX ``ShardedFleetEngine`` runs it on 4 forced host devices
in a subprocess; the port's runs it on 4 ``gloo`` ranks of the CPU
(``sharded_ranks``) from the same weights, converted by
``repro_torch.convert``.  The cohort groups do not all divide by 4, so
zero-weight padding lanes run beside real splits.  Medoids must be
equal, params and losses within 1e-5 (the reference's summation-order
tolerance), and every rank's params bit-identical.

Also here: an explicit ``ShardedFleetEngine`` on a one-rank process
group against the batched engine (the reference's one-device case), the
fall back to batched without a process group, and the mesh's checks.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import sharded_ranks as sr  # noqa: E402
from conftest import fleet_bundle  # noqa: E402
from repro.utils.xla_env import forced_host_device_env  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fed.fleet import (  # noqa: E402
    AsyncFleetConfig, FleetConfig, FleetEngine, ShardedFleetEngine,
    client_mesh, make_cohort_groups, nominal_budgets, run_async_fleet,
    run_fleet, run_fleet_round)
from repro_torch.fed.simulator import (ClientSpec,  # noqa: E402
                                       straggler_deadline)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 4
CFG = dict(epochs=3, batch_size=16, lr=0.05, seed=0)

# the JAX package's sharded round on 4 forced host devices: the
# reference test's payload, written to an npz (params under the port's
# dotted names)
JAX_WORKER = r"""
import sys
import jax
import numpy as np
sys.path.insert(0, sys.argv[2])
from conftest import fleet_bundle
from repro.fed.fleet.batched import (FleetConfig, nominal_budgets,
                                     run_fleet_round)
from repro.fed.fleet.sharded import ShardedFleetEngine, client_mesh
from repro.fed.simulator import straggler_deadline

b = fleet_bundle(workload="mlp", n_clients=18, seed=3,
                 scenario="device_classes")
cfg = FleetConfig(epochs=3, batch_size=16, lr=0.05, seed=0)
deadline = straggler_deadline(b.specs, cfg.epochs, 40.0)
budgets = nominal_budgets(b.specs, deadline, cfg.epochs)
eng = ShardedFleetEngine(b.model, cfg, mesh=client_mesh())
ps, st = run_fleet_round(eng, b.model.init(jax.random.PRNGKey(0)), b.train,
                         list(range(len(b.specs))), budgets, round_seed=0,
                         mode="sharded")
out = {"n_devices": np.array(len(jax.devices())),
       "mesh_devices": np.array(eng.n_devices), "cids": st.cids,
       "losses": st.losses, "used_coreset": st.used_coreset}
for path, leaf in jax.tree_util.tree_flatten_with_path(ps)[0]:
    out["param:" + ".".join(str(k.key) for k in path)] = np.asarray(leaf)
for cid, m in st.medoids.items():
    out[f"med:{cid}"] = np.asarray(m)
np.savez(sys.argv[1], **out)
"""


def _reference_fleet():
    """The reference test's fleet: data, port specs, budgets, JAX init
    weights in the port's layout."""
    b = fleet_bundle(workload="mlp", n_clients=18, seed=3,
                     scenario="device_classes")
    specs = [ClientSpec(s.cid, s.m, s.c) for s in b.specs]
    deadline = straggler_deadline(specs, CFG["epochs"], 40.0)
    budgets = nominal_budgets(specs, deadline, CFG["epochs"])
    jp = jax.tree.map(np.asarray, b.model.init(jax.random.PRNGKey(0)))
    params = {k: v.numpy()
              for k, v in params_from_jax("mlp", jp, device="cpu").items()}
    return b.train, specs, budgets, params


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """(the JAX payload, the port's 4 ranks' results, the fleet): the
    JAX subprocess runs while the ranks do."""
    tmp = tmp_path_factory.mktemp("sharded4")
    train, specs, budgets, params = _reference_fleet()
    out = tmp / "jax.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_WORKER, str(out),
         os.path.join(REPO, "tests")],
        env=forced_host_device_env(N_RANKS, REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = sr.run_ranks(sr.sharded_round, N_RANKS, tmp, train,
                             [(s.cid, s.m, s.c) for s in specs], budgets,
                             CFG, params)
    finally:
        stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    with np.load(out) as z:
        ref = {k: z[k] for k in z.files}
    return ref, ranks, (train, budgets, params)


def test_groups_split_unevenly_with_stragglers(four):
    ref, ranks, (train, budgets, _) = four
    groups = make_cohort_groups(train, list(range(len(train))), budgets,
                                FleetConfig(**CFG))
    assert any(g.n_clients % N_RANKS for g in groups)
    assert any(g.k > 0 for g in groups)
    assert int(ref["n_devices"]) == int(ref["mesh_devices"]) == N_RANKS
    for r in ranks:
        assert r["n_devices"] == N_RANKS
        assert r["dispatches"] == len(groups)     # one a group, as batched
        assert r["used_coreset"].sum() > 0
        np.testing.assert_array_equal(r["used_coreset"], ref["used_coreset"])
        np.testing.assert_array_equal(r["cids"], ref["cids"])


def test_medoids_equal_jax_sharded_engine(four):
    ref, ranks, _ = four
    want = {int(k[4:]): v for k, v in ref.items() if k.startswith("med:")}
    assert want
    for r in ranks:
        assert sorted(r["medoids"]) == sorted(want)
        for cid, med in want.items():
            np.testing.assert_array_equal(r["medoids"][cid], med,
                                          err_msg=str(cid))


def test_params_and_losses_within_summation_tolerance(four):
    ref, ranks, _ = four
    for r in ranks:
        for k, v in r["params"].items():
            np.testing.assert_allclose(v, ref[f"param:{k}"], rtol=0,
                                       atol=1e-5, err_msg=k)
        np.testing.assert_allclose(r["losses"], ref["losses"], atol=1e-5)


def test_every_rank_holds_the_same_bits(four):
    _, ranks, _ = four
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            assert np.array_equal(r["params"][k], v), k
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# the reference's one-device fleet (tests/test_fleet.py ``fleet_fl``)
MLP16 = dict(workload="mlp", n_clients=16, mean=60.0, std=40.0, seed=3,
             spec_seed=3)


def test_one_rank_engine_matches_batched(one_rank):
    """The reference's one-device case: an explicit engine on a one-rank
    mesh runs the whole sharded path (padding, the all-reduce, the
    gathers) without a split."""
    wl, train, _, specs = sr.fleet(**MLP16)
    cfg = FleetConfig(**CFG)
    budgets = nominal_budgets(specs, straggler_deadline(specs, 3, 40.0), 3)
    params = wl.init(torch.Generator().manual_seed(0), "cpu")
    cids = list(range(len(specs)))
    batched = FleetEngine(wl, cfg, device="cpu")
    pb, sb = run_fleet_round(batched, params, train, cids, budgets)
    eng = ShardedFleetEngine(wl, cfg, mesh=client_mesh(devices=["cpu"]),
                             device="cpu")
    ps, ss = run_fleet_round(eng, params, train, cids, budgets,
                             mode="sharded")
    assert (eng.n_devices, eng.rank) == (1, 0)
    assert sb.used_coreset.sum() > 0
    for k in pb:
        np.testing.assert_allclose(ps[k].numpy(), pb[k].numpy(), atol=1e-5)
    assert sorted(sb.medoids) == sorted(ss.medoids)
    for cid in sb.medoids:
        np.testing.assert_array_equal(ss.medoids[cid], sb.medoids[cid])
    np.testing.assert_allclose(ss.losses, sb.losses, atol=1e-5)
    assert eng.dispatch_count == batched.dispatch_count
    # a one-rank group runs the batched engine, as one device does
    out = run_fleet(wl, train, specs, cfg, 1, straggler_pct=40.0,
                    engine="sharded", device="cpu")
    assert (out["engine_mode"], out["n_devices"]) == ("batched", 1)
    with pytest.raises(ValueError, match="2 devices"):
        client_mesh(n_devices=2, devices=["cpu"])


def test_without_a_process_group_sharded_runs_batched():
    wl, train, test, specs = sr.fleet(**MLP16)
    cfg = FleetConfig(epochs=2, batch_size=16, seed=0)

    def run(engine):
        return run_fleet(wl, train, specs, cfg, 2, test_data=test,
                         engine=engine, device="cpu")

    a, s = run("batched"), run("sharded")
    assert (s["engine"], s["engine_mode"]) == ("sharded", "batched")
    assert s["history"] == a["history"]
    assert all(torch.equal(s["params"][k], v) for k, v in a["params"].items())
    acfg = AsyncFleetConfig(max_updates=2, buffer_k=3, concurrency=5,
                            epochs=1, batch_size=16)
    ab, asd = (run_async_fleet(wl, train, specs, acfg, engine=e,
                               device="cpu") for e in ("batched", "sharded"))
    assert asd["engine_mode"] == "batched"
    assert asd["event_log"] == ab["event_log"]
    with pytest.raises(RuntimeError, match="init_process_group"):
        client_mesh()
