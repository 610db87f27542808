"""The async fleet engine under the fault axis, and the ``async_fleet``
runtime of ``run_scenario``, against the JAX package's.

Every profile of ``FAULT_PROFILES`` runs through the port's batched
``run_async_fleet`` and the reference's loop engine on the fleet of
``tests/test_torch_async_fleet.py`` (mlp, 6 clients, 3 flushes of 3),
with the linear ``fedbuff`` merge and with the robust ``trimmed_mean``
one: churn masks the dispatch waves, dropout loses completions after
their dispatch was accounted, and Byzantine corruption rewrites lanes
against their dispatch snapshot before the merge.  The event log must
be equal byte for byte, the dropped and corrupted counts (telemetry and
fault counters) equal, the records and telemetry as
``check_against_reference`` holds them, and the parameters within 1e-5.

``run_scenario(..., "async_fleet")`` runs the ``mlp`` workload (8
clients it builds itself, a flush of 4, 2 flushes) against the JAX
``run_scenario`` on the same data and the converted JAX init: the
default FedBuff merge, delayed gradients, a fault profile with a robust
rule by name, the loop engine and the adaptive scheduler.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import repro.fed.fleet.async_engine as ja  # noqa: E402
import repro.fed.fleet.faults as jf  # noqa: E402
from repro.fed.fleet import scenarios as js  # noqa: E402
from repro.fed.fleet import scheduler as jsched  # noqa: E402
from repro.fed.fleet import workloads as jw  # noqa: E402
from repro.obs import InMemorySink as JInMemorySink  # noqa: E402
from repro.obs import Recorder as JRecorder  # noqa: E402
from repro.obs import use_recorder as j_use_recorder  # noqa: E402
from repro.obs.schema import validate_records  # noqa: E402
import torch  # noqa: E402

import repro_torch.fed.fleet.async_engine as ta  # noqa: E402
from repro_torch.fed.fleet import (AdaptiveParticipation,  # noqa: E402
                                   ParticipationConfig, run_scenario)
from repro_torch.fed.simulator import ClientSpec  # noqa: E402
from repro_torch.obs import InMemorySink, Recorder, use_recorder  # noqa: E402

from test_torch_async_fleet import (_port, _recording,  # noqa: E402
                                    _reference, check_against_reference,
                                    check_medoids)
from test_torch_scenarios import _port_workload  # noqa: E402

torch.set_num_threads(1)

PROFILES = sorted(jf.FAULT_PROFILES)
# the fault counters and gauges both packages keep
FAULT_METRICS = ("faults.dropped_updates", "faults.corrupted_updates",
                 "faults.churn_joins", "faults.churn_leaves",
                 "faults.n_present", "dispatches",
                 "aggregator.partial_flushes", "deadline_violations")


def _fault_metrics(rec):
    snap = rec.metrics.snapshot()
    both = dict(snap["counters"], **snap["gauges"])
    return {k: v for k, v in both.items() if k in FAULT_METRICS}


@pytest.mark.parametrize("aggregator", ["fedbuff", "trimmed_mean"])
@pytest.mark.parametrize("profile", PROFILES)
def test_run_async_fleet_under_faults_matches_reference(profile, aggregator,
                                                        monkeypatch):
    jrecorder = JRecorder([JInMemorySink()])
    with j_use_recorder(jrecorder):
        jout, jrec = _reference(("faults", profile, aggregator), "mlp",
                                monkeypatch, aggregator=aggregator,
                                faults=profile)
    rec = _recording(monkeypatch, ta)
    recorder = Recorder([InMemorySink()])
    with use_recorder(recorder):
        out = _port("mlp", aggregator=aggregator, faults=profile)
    assert out["faults"] == jout["faults"] == profile
    check_against_reference(out, jout, "mlp", "batched", jrec)
    check_medoids(rec, jrec)
    assert _fault_metrics(recorder) == _fault_metrics(jrecorder)
    tel = out["telemetry"]
    counters = recorder.metrics.snapshot()["counters"]
    assert tel["n_dropped_updates"] == counters.get(
        "faults.dropped_updates", 0)
    assert tel["n_corrupted_updates"] == counters.get(
        "faults.corrupted_updates", 0)
    fp = jf.FAULT_PROFILES[profile]
    # an axis that is off injects nothing; a profile of one axis shows it
    assert not (tel["n_dropped_updates"] and not fp.has_dropout)
    assert not (tel["n_corrupted_updates"] and not fp.has_corruption)
    if profile in ("dropout", "byzantine_signflip", "byzantine_noise",
                   "byzantine_boost", "hostile"):
        assert tel["n_dropped_updates"] + tel["n_corrupted_updates"] > 0
    if profile == "churn":      # absent clients were kept out of a wave
        gauges = recorder.metrics.snapshot()["gauges"]
        assert gauges["faults.n_present"] < 6      # of the fleet's 6


RUN = dict(seed=0, rounds=2, clients_per_round=4, epochs=2, batch_size=8,
           lr=0.05, straggler_pct=30.0, n_clients=8)


@pytest.mark.parametrize("scenario,extra", [
    ("uniform", {}),
    ("diurnal", {"aggregator": "delayed_grad"}),
    ("pareto", {"faults": "hostile", "aggregator": "trimmed_mean"}),
    ("uniform", {"fleet_engine": "loop", "aggregator": "fedasync",
                 "max_updates": 3}),
    ("diurnal", {"scheduler": True})])
def test_run_scenario_async_fleet_matches_reference(scenario, extra,
                                                   monkeypatch):
    kw = dict(RUN, **extra)
    jkw, tkw = dict(kw, fleet_engine="loop"), dict(kw)
    if kw.pop("scheduler", False):
        clients = jw.get_workload("mlp").make_clients(n_clients=8, seed=0)
        jspecs, _ = js.build_scenario(scenario, [len(d["y"])
                                                 for d in clients], 0)
        cfg = dict(min_cohort=3, explore_frac=0.25, seed=3)
        jkw["scheduler"] = jsched.AdaptiveParticipation(
            jspecs, jsched.ParticipationConfig(**cfg))
        tkw["scheduler"] = AdaptiveParticipation(
            [ClientSpec(s.cid, s.m, s.c) for s in jspecs],
            ParticipationConfig(**cfg))
    jrecorder = JRecorder([JInMemorySink()])
    with j_use_recorder(jrecorder), monkeypatch.context() as mp:
        jrec = _recording(mp, ja)
        jout = js.run_scenario(scenario, "async_fleet", workload="mlp",
                               **jkw)
    rec = _recording(monkeypatch, ta)
    sink = InMemorySink()
    recorder = Recorder([sink])
    with use_recorder(recorder):
        out = run_scenario(scenario, "async_fleet",
                           workload=_port_workload("mlp"), device="cpu",
                           **tkw)
    validate_records(sink.records)
    assert sink.records[0]["name"] == "scenario"
    for key in ("scenario", "runtime", "workload", "faults", "aggregator"):
        assert out[key] == jout[key], key
    assert out["runtime"] == "async_fleet"
    assert sum(h.n_coreset for h in out["history"]) > 0
    check_against_reference(out, jout, "mlp",
                            kw.get("fleet_engine", "batched"), jrec)
    check_medoids(rec, jrec)
    assert _fault_metrics(recorder) == _fault_metrics(jrecorder)
    if "scheduler" in tkw:
        assert tkw["scheduler"].summary() == jkw["scheduler"].summary()


def test_scenario_threads_the_config_through():
    """``buffer_k = clients_per_round``, ``concurrency = max(concurrency,
    clients_per_round)`` and ``max_updates = max_updates or rounds``, as
    the reference's runtime builds them."""
    seen = []
    inner = ta.run_async_fleet

    def spy(model, clients, specs, cfg, **kwargs):
        seen.append((cfg, kwargs))
        return inner(model, clients, specs, cfg, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(ta, "run_async_fleet", spy)
    try:
        out = run_scenario("uniform", "async_fleet", workload="mlp",
                           n_clients=6, rounds=1, clients_per_round=5,
                           concurrency=2, epochs=2, use_kernel=False,
                           device="cpu")
    finally:
        mp.undo()
    cfg, kwargs = seen[0]
    assert (cfg.buffer_k, cfg.concurrency, cfg.max_updates,
            cfg.use_kernel, cfg.epochs) == (5, 5, 1, False, 2)
    assert cfg.trace is not None
    assert kwargs["engine"] == "batched" and kwargs["device"] == "cpu"
    assert out["applied"] == 1


@pytest.mark.parametrize("profile", ["dropout", "byzantine_signflip",
                                     "hostile"])
def test_fault_counts_replay_from_the_event_log(profile):
    """The dropped and corrupted counts are what the ``FaultTrace``
    draws for the log's completions: each completion keyed by its
    client's dispatch ordinal, a dropped one lost, every other one of a
    Byzantine client corrupted when its flush merges."""
    from repro_torch.fed.fleet import FAULT_PROFILES, FaultTrace

    out = _port("mlp", aggregator="trimmed_mean", faults=profile)
    ft = FaultTrace(FAULT_PROFILES[profile], 6, seed=0)
    counts = np.zeros(6, np.int64)
    dropped = corrupted = 0
    for line in out["event_log"]:
        fields = line.split()
        cid = int(fields[3][len("cid="):])
        if fields[2] == "dispatch":
            counts[cid] += 1
        elif ft.dropped(cid, int(counts[cid]) - 1):
            dropped += 1
        else:
            corrupted += int(ft.byzantine[cid])
    tel = out["telemetry"]
    assert (tel["n_dropped_updates"], tel["n_corrupted_updates"]) == \
        (dropped, corrupted)
    assert dropped + corrupted > 0
