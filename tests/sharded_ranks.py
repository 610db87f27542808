"""Rank processes for the sharded fleet engine's CPU tests.

``run_ranks(fn, world, tmp_path, *args)`` starts ``world``
``torch.multiprocessing`` ranks on the CPU, each in a ``gloo`` process
group initialised through ``file://<tmp_path>/init`` with one intra-op
thread, calls ``fn(rank, world, *args)`` in each and returns their
results in rank order.  The rank bodies live here, in a module that
imports no JAX, so a rank starts with torch and the port alone; the tests
compute their references in the test process.
"""
from __future__ import annotations

import contextlib
import datetime
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 240.0


def _rank_main(rank: int, world: int, out_dir: str, fn, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/init", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, f"{out_dir}/rank{rank}.pt")


def run_ranks(fn, world: int, tmp_path: Path, *args) -> List[Any]:
    """``[fn(rank, world, *args) for each rank]``, run on ``world`` gloo
    ranks; a rank's exception fails the call with its traceback, and
    ranks still running after ``RANK_TIMEOUT_S`` are killed."""
    out_dir = Path(tmp_path) / f"ranks_{fn.__name__}"
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world, str(out_dir), fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} ranks still running "
                                   f"after {RANK_TIMEOUT_S:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


# ---------------------------------------------------------------------------
# fleets and runs, shared by the ranks and the tests' batched references
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def patched(obj, name: str, value):
    """``setattr(obj, name, value)`` for the block's duration."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def fleet(workload: str, n_clients: int = 6, mean: float = 24.0,
          std: float = 8.0, seed: int = 0, spec_seed: int = 0):
    """(workload, train, test, specs): by default the conformance
    matrix's small fleet, built from seeds, the same in every process."""
    from repro_torch.data.partition import train_test_split_clients
    from repro_torch.fed.fleet import get_workload
    from repro_torch.fed.simulator import make_client_specs

    wl = get_workload(workload)
    clients = wl.make_clients(n_clients=n_clients, seed=seed,
                              mean_samples=mean, std_samples=std)
    train, test = train_test_split_clients(clients, test_frac=0.1)
    specs = make_client_specs([len(d["y"]) for d in train],
                              np.random.default_rng(spec_seed))
    return wl, train, test, specs


@contextlib.contextmanager
def counting():
    """Tally ``FleetEngine.count_dispatch`` calls and the sharded groups
    run with their per-client stack gathered."""
    from repro_torch.fed.fleet.batched import FleetEngine
    from repro_torch.fed.fleet.sharded import ShardedFleetEngine

    tally = {"dispatches": 0, "stack_gathers": 0}
    count, run_sharded = (FleetEngine.count_dispatch,
                          ShardedFleetEngine.run_group_sharded)

    def count_dispatch(self, n=1):
        tally["dispatches"] += n
        count(self, n)

    def run_group_sharded(self, params, group, weights, gather_stack=False):
        tally["stack_gathers"] += bool(gather_stack)
        return run_sharded(self, params, group, weights, gather_stack)

    with patched(FleetEngine, "count_dispatch", count_dispatch), \
            patched(ShardedFleetEngine, "run_group_sharded",
                    run_group_sharded):
        yield tally


def fleet_run(case: Dict[str, Any], engine: str):
    """``run_fleet`` on ``case``'s fleet; returns the final params, the
    history, each round's medoids, round-start params and fault flags,
    the dispatch tally and what the run records."""
    import repro_torch.fed.fleet.batched as tb
    from repro_torch.fed.fleet import FleetConfig, run_fleet
    from repro_torch.obs import InMemorySink, Recorder, use_recorder

    wl, train, test, specs = fleet(**case["fleet"])
    rounds, inner = [], tb.run_fleet_round

    def run_fleet_round(*args, **kw):
        params, stats = inner(*args, **kw)
        rounds.append({"medoids": {int(c): np.asarray(m)
                                   for c, m in stats.medoids.items()},
                       "params0": _numpy(args[1]),
                       "dropped": stats.dropped.copy(),
                       "corrupted": stats.corrupted.copy()})
        return params, stats

    sink = InMemorySink()
    with patched(tb, "run_fleet_round", run_fleet_round), counting() as n, \
            use_recorder(Recorder([sink])):
        out = run_fleet(wl, train, specs, FleetConfig(**case["cfg"]),
                        case["rounds"], straggler_pct=40.0, test_data=test,
                        engine=engine, faults=case.get("faults"),
                        device="cpu")
    return {"params": _numpy(out["params"]), "history": out["history"],
            "rounds": rounds, "engine_mode": out["engine_mode"],
            "n_devices": out["n_devices"], **n,
            "records": [r["kind"] for r in sink.records],
            "spans": {r["name"] for r in sink.records
                      if r["kind"] == "span"},
            "sharded_spans": sum(1 for r in sink.records
                                 if r["kind"] == "span"
                                 and r["attrs"].get("sharded"))}


def async_run(case: Dict[str, Any], engine: str):
    """``run_async_fleet`` on ``case``'s fleet; returns the params,
    history, event log, telemetry and medoids per (flush, client)."""
    import repro_torch.fed.fleet.async_engine as ta
    from repro_torch.fed.fleet import AsyncFleetConfig, run_async_fleet
    from repro_torch.fed.fleet.batched import FleetEngine
    from repro_torch.fed.fleet.sharded import ShardedFleetEngine

    wl, train, test, specs = fleet(**case["fleet"])
    medoids, current = {}, []
    groups = ta.make_cohort_groups
    run_group, run_sharded = (FleetEngine.run_group,
                              ShardedFleetEngine.run_group_sharded)

    def make_cohort_groups(*args, round_seed=0, **kw):
        current[:] = [round_seed]
        medoids.setdefault(round_seed, {})
        return groups(*args, round_seed=round_seed, **kw)

    def keep(group, meds):
        if meds is not None:
            medoids[current[0]].update(
                {int(c): np.asarray(m) for c, m in zip(group.cids, meds)})

    def recording_run_group(self, params, group, batched=True):
        out = run_group(self, params, group, batched)
        keep(group, out[2])
        return out

    def recording_run_sharded(self, params, group, weights,
                              gather_stack=False):
        out = run_sharded(self, params, group, weights, gather_stack)
        keep(group, out[3])
        return out

    with patched(ta, "make_cohort_groups", make_cohort_groups), \
            patched(FleetEngine, "run_group", recording_run_group), \
            patched(ShardedFleetEngine, "run_group_sharded",
                    recording_run_sharded), counting() as n:
        out = run_async_fleet(wl, train, specs,
                              AsyncFleetConfig(**case["cfg"]),
                              aggregator=case.get("aggregator"),
                              test_data=test, faults=case.get("faults"),
                              engine=engine, device="cpu")
    return {"params": _numpy(out["params"]), "history": out["history"],
            "event_log": out["event_log"], "telemetry": out["telemetry"],
            "medoids": medoids, "engine_mode": out["engine_mode"],
            "n_devices": out["n_devices"], **n}


def scenario_run(case: Dict[str, Any], engine: str):
    """``run_scenario`` with ``fleet_engine=engine``; returns its params,
    history and engine mode."""
    from repro_torch.fed.fleet import run_scenario

    out = run_scenario(fleet_engine=engine, device="cpu", **case)
    return {"params": _numpy(out["params"]), "history": out["history"],
            "engine_mode": out["engine_mode"],
            "event_log": out.get("event_log")}


def resume_run(case: Dict[str, Any], engine: str):
    """The reference resume test's fleet (mlp, 20 clients, the adaptive
    scheduler, dropout): uninterrupted for ``case["upto"]`` rounds (or
    flushes), then checkpointed every one up to ``case["cut"]`` under
    ``case["dir"]`` and resumed to ``upto``; returns both runs and the
    checkpoints this process wrote."""
    import repro_torch.fed.fleet.async_engine as ta
    import repro_torch.fed.fleet.batched as tb
    from repro_torch.fed.fleet import (AdaptiveParticipation,
                                       AsyncFleetConfig, FleetConfig,
                                       run_async_fleet, run_fleet)

    wl, train, test, specs = fleet("mlp", n_clients=20, mean=60.0, std=40.0,
                                   seed=3, spec_seed=3)
    saved = []
    module = ta if case["async"] else tb
    save = module.save_server_state

    def save_server_state(*args, **kwargs):
        saved.append(args[1])
        return save(*args, **kwargs)

    def run(upto, **kwargs):
        common = dict(scheduler=AdaptiveParticipation(specs),
                      test_data=test, faults="dropout", engine=engine,
                      device="cpu", **kwargs)
        if case["async"]:
            cfg = AsyncFleetConfig(max_updates=upto, buffer_k=5,
                                   concurrency=10, epochs=1, batch_size=8,
                                   seed=0, eval_every=1)
            out = run_async_fleet(wl, train, specs, cfg, **common)
        else:
            out = run_fleet(wl, train, specs,
                            FleetConfig(epochs=1, batch_size=8, seed=0),
                            upto, **common)
        return {"params": _numpy(out["params"]), "history": out["history"],
                "event_log": out.get("event_log"),
                "engine_mode": out["engine_mode"]}

    with patched(module, "save_server_state", save_server_state):
        full = run(case["upto"])
        run(case["cut"], checkpoint_dir=case["dir"], checkpoint_every=1)
        resumed = run(case["upto"], checkpoint_dir=case["dir"], resume=True)
    return {"full": full, "resumed": resumed, "saved": saved}


RUNS = {"fleet": fleet_run, "async": async_run, "scenario": scenario_run,
        "resume": resume_run}


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def check_medoids(fleet_kw: Dict[str, Any], got, want):
    """The medoids per (round, client) of two ``fleet_run`` results on
    the fleet ``fleet(**fleet_kw)`` equal; where a round after the first
    picks another coreset, the two coresets must be tied: their float64
    k-medoids objectives over the client's features at ``want``'s
    round-start params within 1e-9 relative (the near-tie rule: the two
    runs' params differ in the last bits after an aggregation).  Returns
    the tied (round, client)s."""
    from repro_torch.core.kmedoids import medoid_objective_f64

    wl, train, _, _ = fleet(**fleet_kw)
    ties = []
    for r, (a, b) in enumerate(zip(got["rounds"], want["rounds"])):
        assert sorted(a["medoids"]) == sorted(b["medoids"]), r
        for cid, med in b["medoids"].items():
            if np.array_equal(a["medoids"][cid], med):
                continue
            assert r > 0, (r, cid)      # round 0 starts from equal params
            params = {k: torch.as_tensor(v) for k, v in b["params0"].items()}
            data = {k: torch.as_tensor(v) for k, v in train[cid].items()}
            with torch.no_grad():
                feats = wl.grad_features(params, data).double().numpy()
            fa = medoid_objective_f64(feats, a["medoids"][cid])
            fb = medoid_objective_f64(feats, med)
            assert abs(fa - fb) <= 1e-9 * abs(fb), (r, cid, fa, fb)
            ties.append((r, cid))
    return ties


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def jobs(rank: int, world: int, todo):
    """Each ``(kind, case)`` of ``todo`` run sharded."""
    return [RUNS[kind](case, "sharded") for kind, case in todo]


def sharded_round(rank: int, world: int, train, specs, budgets, cfg_kw,
                  params):
    """One ``run_fleet_round(mode="sharded")`` of the mlp workload from
    ``params`` (numpy, the port's layout)."""
    from repro_torch.fed.fleet import FleetConfig, get_workload
    from repro_torch.fed.fleet.batched import run_fleet_round
    from repro_torch.fed.fleet.sharded import ShardedFleetEngine

    eng = ShardedFleetEngine(get_workload("mlp"), FleetConfig(**cfg_kw),
                             device="cpu")
    ps, stats = run_fleet_round(
        eng, {k: torch.as_tensor(v) for k, v in params.items()}, train,
        list(range(len(specs))), budgets, round_seed=0, mode="sharded")
    return {"params": _numpy(ps), "cids": stats.cids,
            "losses": stats.losses, "medoids": stats.medoids,
            "used_coreset": stats.used_coreset,
            "dispatches": eng.dispatch_count, "n_devices": eng.n_devices}


def fedavg_cases(rank: int, world: int, silos, weights):
    """``fedavg_allreduce`` and ``weighted_psum_sum`` on a 4-rank mesh:
    the reference's closed-form cases on ("data", "model") = (2, 2), the
    seeded ``silos`` (8 of them, with ``weights``) over "data" there and
    over both dims of a ("pod", "data") = (2, 2) mesh; each rank holds
    its block of silos."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import fedavg_allreduce, weighted_psum_sum

    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    pm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))

    def block(tree, i, n):
        return {k: torch.as_tensor(v[i * n:(i + 1) * n])
                for k, v in tree.items()}

    d = dm.get_local_rank("data")
    n = 4
    closed = {"w": np.arange(float(n))[:, None] * np.ones((n, 3)),
              "b": np.arange(float(n))}
    out = {
        "uniform": fedavg_allreduce(block(closed, d, 2), np.ones(2), dm,
                                    client_axes=("data",)),
        "weighted": fedavg_allreduce(block(closed, d, 2),
                                     np.array([1., 1., 1., 5.])[2 * d:2 * d
                                                                + 2],
                                     dm, client_axes=("data",)),
        "data": fedavg_allreduce(block(silos, d, 4), weights[4 * d:4 * d + 4],
                                 dm, client_axes=("data",)),
    }
    p = pm.get_local_rank("pod") * 2 + pm.get_local_rank("data")
    out["pod_data"] = fedavg_allreduce(block(silos, p, 2),
                                       weights[2 * p:2 * p + 2], pm)
    summed, total = weighted_psum_sum(weights[2 * rank:2 * rank + 2],
                                      block(silos, rank, 2))
    out["psum"] = dict(summed, total=total)
    return {k: _numpy(v) for k, v in out.items()}
