"""Checkpoint and resume of the port's fleet and async fleet engines.

The pin of the reference's ``tests/test_faults.py``: on its workload
(the ``mlp`` fleet of 20 clients, ``faults="dropout"``, an
``AdaptiveParticipation`` scheduler, test-set eval every round), a run
checkpointed every round, cut and resumed ends byte for byte as the
uninterrupted run: the same parameters bit for bit, an equal history
and, for the async fleet, an equal event log, in both of the port's
engines.  Beside it: the checkpoint files and the ``checkpoint`` span a
run writes, a resume with no checkpoint starting afresh, the async
fleet taking no checkpoint on a partial flush, and the port's fleet
meta JSON against the JAX ``run_fleet``'s on the same run (integer
fields and dispatch cursors equal, the scheduler state and the loss
floats within the reference's ``PARAMS_ATOL``, 1e-5 for the mlp).
"""
import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

from conftest import fleet_bundle  # noqa: E402
import repro.fed.fleet.batched as jb  # noqa: E402
from repro.checkpoint import load_server_meta as j_load_meta  # noqa: E402
from repro.fed.fleet.scheduler import (  # noqa: E402
    AdaptiveParticipation as JAdaptiveParticipation)
import torch  # noqa: E402

from repro_torch.checkpoint import load_server_meta  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fed.fleet import (AdaptiveParticipation,  # noqa: E402
                                   AsyncFleetConfig, FleetConfig,
                                   get_workload, run_async_fleet, run_fleet)
from repro_torch.fed.simulator import ClientSpec  # noqa: E402
from repro_torch.obs import InMemorySink, Recorder, use_recorder  # noqa: E402

torch.set_num_threads(1)

PARAMS_ATOL = 1e-5
FLEET_CFG = dict(epochs=1, batch_size=8, seed=0)
ASYNC_CFG = AsyncFleetConfig(max_updates=5, buffer_k=5, concurrency=10,
                             epochs=1, batch_size=8, seed=0, eval_every=1)

_cache = {}


def _bundle():
    """The reference test's fleet: data, port specs, JAX init weights."""
    if not _cache:
        b = fleet_bundle("mlp", n_clients=20)
        specs = [ClientSpec(s.cid, s.m, s.c) for s in b.specs]
        jp = jax.tree.map(np.asarray, b.model.init(jax.random.PRNGKey(0)))
        _cache["b"] = (b, specs, jp)
    return _cache["b"]


def _fleet(rounds, engine, **kwargs):
    b, specs, jp = _bundle()
    return run_fleet(get_workload("mlp"), b.train, specs,
                     FleetConfig(**FLEET_CFG), rounds,
                     scheduler=AdaptiveParticipation(specs),
                     test_data=b.test, faults="dropout", engine=engine,
                     init_params=params_from_jax("mlp", jp, device="cpu"),
                     device="cpu", **kwargs)


def _async_fleet(cfg, engine, **kwargs):
    b, specs, jp = _bundle()
    return run_async_fleet(get_workload("mlp"), b.train, specs, cfg,
                           scheduler=AdaptiveParticipation(specs),
                           test_data=b.test, faults="dropout",
                           engine=engine,
                           init_params=params_from_jax("mlp", jp,
                                                       device="cpu"),
                           device="cpu", **kwargs)


def _same_params(a, b):
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def _records(history):
    return [h.__dict__ for h in history]


@pytest.mark.parametrize("engine", ["batched", "loop"])
def test_fleet_resume_byte_identity(engine, tmp_path):
    full = _fleet(5, engine)
    d = str(tmp_path / "fleet")
    sink = InMemorySink()
    with use_recorder(Recorder([sink])):
        _fleet(3, engine, checkpoint_dir=d, checkpoint_every=1)
    assert sorted(os.listdir(d)) == [f"ckpt_{r:06d}.{ext}" for r in range(3)
                                     for ext in ("json", "npz")]
    assert [s["attrs"]["round"] for s in sink.records
            if s["kind"] == "span" and s["name"] == "checkpoint"] == [0, 1, 2]
    sink = InMemorySink()
    with use_recorder(Recorder([sink])):
        res = _fleet(5, engine, checkpoint_dir=d, resume=True)
    assert [r["data"]["round"] for r in sink.records
            if r["kind"] == "event" and r["name"] == "resume"] == [3]
    assert _same_params(full["params"], res["params"])
    assert _records(full["history"]) == _records(res["history"])
    assert full["cohort_sizes"] == res["cohort_sizes"]
    assert all(v.device.type == "cpu" for v in res["params"].values())


def test_fleet_checkpoint_every_and_resume_without_checkpoint(tmp_path):
    d = str(tmp_path / "fleet")
    fresh = _fleet(2, "batched", checkpoint_dir=d, resume=True)
    assert not os.path.exists(d)
    _fleet(4, "batched", checkpoint_dir=d, checkpoint_every=2)
    assert sorted(n for n in os.listdir(d) if n.endswith(".npz")) == \
        ["ckpt_000001.npz", "ckpt_000003.npz"]
    meta = load_server_meta(d)
    assert meta["kind"] == "fleet" and meta["round"] == 3
    assert len(meta["history"]) == 4 and len(meta["cohort_sizes"]) == 4
    plain = _fleet(2, "batched")
    assert _same_params(fresh["params"], plain["params"])


def test_fleet_meta_matches_reference(tmp_path):
    """The port's fleet meta JSON against the JAX ``run_fleet``'s meta
    after the same 3 rounds from the same weights."""
    b, specs, jp = _bundle()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jb.run_fleet(b.model, b.train, b.specs, jb.FleetConfig(**FLEET_CFG), 3,
                 scheduler=JAdaptiveParticipation(b.specs),
                 test_data=b.test, faults="dropout", engine="loop",
                 init_params=jp, checkpoint_dir=jd, checkpoint_every=1)
    _fleet(3, "batched", checkpoint_dir=td, checkpoint_every=1)
    want, got = j_load_meta(jd), load_server_meta(td)
    assert set(got) == set(want)
    for key in ("kind", "round", "cohort_sizes", "dispatch_counts"):
        assert got[key] == want[key], key
    assert len(got["history"]) == len(want["history"]) == 3
    for g, w in zip(got["history"], want["history"]):
        for key in ("round", "sim_round_time", "client_times",
                    "n_participants", "n_dropped", "n_coreset",
                    "n_violations", "wall_time"):
            assert g[key] == w[key], key
        for key in ("train_loss", "test_acc", "test_loss"):
            assert abs(g[key] - w[key]) <= PARAMS_ATOL, key
    gs, ws = got["scheduler"], want["scheduler"]
    assert set(gs) == set(ws)
    for key in ("n_obs", "cohort", "stall", "round", "growth_log",
                "rng_state"):
        assert gs[key] == ws[key], key
    np.testing.assert_allclose(gs["observed"], ws["observed"], rtol=0,
                               atol=PARAMS_ATOL)
    assert abs(gs["best_loss"] - ws["best_loss"]) <= PARAMS_ATOL


@pytest.mark.parametrize("engine", ["batched", "loop"])
def test_async_fleet_resume_byte_identity(engine, tmp_path):
    full = _async_fleet(ASYNC_CFG, engine)
    d = str(tmp_path / "async_fleet")
    half = _async_fleet(dataclasses.replace(ASYNC_CFG, max_updates=2),
                        engine, checkpoint_dir=d, checkpoint_every=1)
    assert half["applied"] == 2
    assert sorted(n for n in os.listdir(d) if n.endswith(".npz")) == \
        ["ckpt_000001.npz", "ckpt_000002.npz"]
    meta = load_server_meta(d)
    assert meta["kind"] == "async_fleet" and meta["applied"] == 2
    assert meta["event_log"] == half["event_log"]
    sink = InMemorySink()
    with use_recorder(Recorder([sink])):
        res = _async_fleet(ASYNC_CFG, engine, checkpoint_dir=d, resume=True)
    assert [r["data"]["applied"] for r in sink.records
            if r["kind"] == "event" and r["name"] == "resume"] == [2]
    assert _same_params(full["params"], res["params"])
    assert full["event_log"] == res["event_log"]
    assert _records(full["history"]) == _records(res["history"])
    for key in ("makespan", "n_dispatches", "n_merged_clients",
                "n_dropped_updates", "n_violations", "mean_staleness"):
        assert full["telemetry"][key] == res["telemetry"][key], key


def test_async_fleet_takes_no_checkpoint_on_a_partial_flush(tmp_path):
    """A virtual-time cutoff ends the run on a partial flush: the last
    checkpoint is the last full flush's."""
    d = str(tmp_path / "cut")
    full = _async_fleet(ASYNC_CFG, "batched")
    cut_t = full["telemetry"]["makespan"] * 0.6
    out = _async_fleet(dataclasses.replace(ASYNC_CFG,
                                           max_virtual_time=cut_t),
                       "batched", checkpoint_dir=d, checkpoint_every=1)
    assert out["telemetry"]["n_partial_flushes"] == 1
    meta = load_server_meta(d)
    assert meta["applied"] == out["applied"] - 1
    assert meta["partial_flushes"] == 0
