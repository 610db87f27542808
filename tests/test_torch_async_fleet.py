"""The async fleet engine against the JAX package's.

The merge rules first: each rule's float64 ``coefficients`` must equal
the reference's exactly, and a flush evaluated from them must reproduce
the port's streaming aggregators (K sequential ``FedAsync`` /
``DelayedGradient.apply`` calls, ``FedBuff.flush``) within the reference
tests' 1e-6.  Then ``run_async_fleet`` in both of the port's engines
against the JAX package's ``run_async_fleet(engine="loop")`` on the same
client data, the same converted initial weights and the same seed: the
event log byte for byte, the ``RoundRecord`` timing, participant,
coreset and violation fields and the telemetry's makespan, histograms
and counters exact (``n_group_dispatches`` for the batched engine only:
the loop engine counts one dispatch a step), the medoids equal per
(flush, client), and the parameters within the conformance matrix's
``PARAMS_ATOL`` (1e-5; 2e-4 for the CNN).

The fleet is the conformance matrix's (6 clients, mean 24, std 8, E = 2,
B = 8, 40 % stragglers) with 3 flushes of 3 completions and 5 clients in
flight, so the second and third flushes merge updates of staleness 1.
The xlstm fleet draws its capabilities with seed 7 and the CNN fleet
with seed 5: at the other workloads' seed 0 both meet a client with
k = 16 of m = 29 whose medoid choice is a near-tie that XLA's and
PyTorch's float32 roundings break differently (the fleet tests' note on
SmallCNN).  At these seeds no selection is tied.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

import repro.fed.aggregators as jagg  # noqa: E402
import repro.fed.fleet.async_engine as ja  # noqa: E402
from repro.fed.simulator import make_client_specs  # noqa: E402
from repro.obs.schema import validate_records  # noqa: E402
import torch  # noqa: E402

import repro_torch.fed.aggregators as tagg  # noqa: E402
import repro_torch.fed.fleet.async_engine as ta  # noqa: E402
import repro_torch.fed.fleet.batched as tb  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fed.fleet import (  # noqa: E402
    ASYNC_MERGES, AsyncFleetConfig, as_merge_rule, get_workload,
    run_async_fleet)
from repro_torch.fed.simulator import ClientSpec  # noqa: E402
from repro_torch.obs import InMemorySink, Recorder, use_recorder  # noqa: E402

from conftest import fleet_bundle  # noqa: E402

torch.set_num_threads(1)

PARAMS_ATOL = {"cnn": 2e-4}
CFG = dict(max_updates=3, buffer_k=3, concurrency=5, epochs=2, batch_size=8,
           lr=0.05, straggler_pct=40.0, seed=0)
SPEC_SEED = {"xlstm": 7, "cnn": 5}
# the telemetry's deterministic entries (all but the wall time; the
# group dispatch count only where the engines count alike)
TELEMETRY = ("makespan", "client_utilization", "active_client_utilization",
             "staleness_hist", "mean_staleness", "max_staleness",
             "buffer_occupancy_hist", "mean_buffer_occupancy",
             "n_dispatches", "n_updates_applied", "n_merged_clients",
             "n_partial_flushes", "n_violations", "n_dropped_updates",
             "n_corrupted_updates")

_cache = {}


def _bundle(workload):
    """Client data (the reference's bytes), specs and JAX init weights."""
    if workload not in _cache:
        b = fleet_bundle(workload=workload, n_clients=6, seed=0,
                         mean_samples=24.0, std_samples=8.0)
        specs = make_client_specs(
            [len(d["y"]) for d in b.train],
            np.random.default_rng(SPEC_SEED.get(workload, 0)))
        jp = jax.tree.map(np.asarray, b.workload.init(jax.random.PRNGKey(0)))
        _cache[workload] = (b.workload, b.train, b.test, specs, jp)
    return _cache[workload]


def _recording(monkeypatch, module):
    """Record the medoids {flush: {cid: indices}} of ``module``'s
    ``run_async_fleet`` (its ``make_cohort_groups`` is called with the
    flush's index, then its groups run) and the number of groups run."""
    rec = {"medoids": {}, "groups": 0}
    current = []
    groups, run_group = module.make_cohort_groups, module.FleetEngine.run_group

    def make_cohort_groups(*args, round_seed=0, **kwargs):
        current[:] = [round_seed]
        rec["medoids"].setdefault(round_seed, {})
        return groups(*args, round_seed=round_seed, **kwargs)

    def recording_run_group(self, params, group, batched=True):
        p, losses, meds = run_group(self, params, group, batched)
        rec["groups"] += 1
        if meds is not None:
            rec["medoids"][current[0]].update(
                {int(c): np.asarray(m) for c, m in zip(group.cids, meds)})
        return p, losses, meds

    monkeypatch.setattr(module, "make_cohort_groups", make_cohort_groups)
    monkeypatch.setattr(module.FleetEngine, "run_group", recording_run_group)
    return rec


def _reference(key, workload, monkeypatch, **kw):
    """The JAX loop engine's run (cached under ``key``) and what
    ``_recording`` kept of it."""
    if key not in _cache:
        jwl, train, test, specs, jp = _bundle(workload)
        with monkeypatch.context() as mp:
            rec = _recording(mp, ja)
            cfg = {**CFG, **kw.pop("cfg", {})}
            out = ja.run_async_fleet(jwl, train, specs,
                                     ja.AsyncFleetConfig(**cfg),
                                     test_data=test, init_params=jp,
                                     engine="loop", **kw)
        _cache[key] = (out, rec)
    return _cache[key]


def _port(workload, engine="batched", **kw):
    _, train, test, specs, jp = _bundle(workload)
    cfg = {**CFG, **kw.pop("cfg", {})}
    return run_async_fleet(
        get_workload(workload), train,
        [ClientSpec(s.cid, s.m, s.c) for s in specs], AsyncFleetConfig(**cfg),
        test_data=test, init_params=params_from_jax(workload, jp,
                                                    device="cpu"),
        engine=engine, device="cpu", **kw)


def check_against_reference(out, jout, workload, engine, jrec):
    """The run as the reference's; ``n_group_dispatches`` against the
    reference loop engine's on the loop engine (one a step in both) and
    against the number of groups the reference ran on the batched one."""
    assert out["event_log"] == jout["event_log"]
    assert len(out["event_log"]) > 0
    for name in ("deadline", "version", "applied", "aggregator", "faults",
                 "strategy", "n_devices"):
        assert out[name] == jout[name], name
    assert len(out["history"]) == len(jout["history"])
    for a, b in zip(out["history"], jout["history"]):
        assert (a.round, a.sim_round_time, a.client_times, a.n_participants,
                a.n_dropped, a.n_coreset, a.n_violations) == \
            (b.round, b.sim_round_time, b.client_times, b.n_participants,
             b.n_dropped, b.n_coreset, b.n_violations)
        np.testing.assert_allclose(a.train_loss, b.train_loss, atol=1e-5)
        np.testing.assert_allclose(a.test_acc, b.test_acc, atol=1e-5)
    tel, jtel = out["telemetry"], jout["telemetry"]
    assert set(tel) == set(jtel)
    for name in TELEMETRY:
        np.testing.assert_array_equal(tel[name], jtel[name], err_msg=name)
    assert tel["n_group_dispatches"] == (jtel["n_group_dispatches"]
                                         if engine == "loop"
                                         else jrec["groups"])
    want = params_from_jax(workload, jax.tree.map(np.asarray,
                                                  jout["params"]),
                           device="cpu")
    assert set(out["params"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                   atol=PARAMS_ATOL.get(workload, 1e-5),
                                   rtol=0, err_msg=k)


def check_medoids(rec, jrec):
    got, want = rec["medoids"], jrec["medoids"]
    assert sorted(got) == sorted(want)
    for f in want:
        assert set(got[f]) == set(want[f]), f"flush {f}"
        for cid in want[f]:
            np.testing.assert_array_equal(got[f][cid], want[f][cid],
                                          err_msg=f"flush {f} client {cid}")


# ---------------------------------------------------------------------------
# merge rules
# ---------------------------------------------------------------------------

RULE_KWARGS = {"fedbuff": [{}, {"server_lr": 0.7, "weight_by_samples": True,
                                "staleness_exponent": 1.5}],
               "fedasync": [{}, {"mixing": 0.3, "staleness_exponent": 1.0}],
               "delayed_grad": [{}, {"server_lr": 0.8,
                                     "staleness_exponent": 0.25}]}


@pytest.mark.parametrize("name", sorted(ASYNC_MERGES))
def test_coefficients_equal_reference_exactly(name):
    rng = np.random.default_rng(sorted(ASYNC_MERGES).index(name))
    for kw in RULE_KWARGS.get(name, [{}]):
        got_rule, want_rule = ASYNC_MERGES[name](**kw), \
            ja.ASYNC_MERGES[name](**kw)
        assert (got_rule.use_base, got_rule.robust) == \
            (want_rule.use_base, want_rule.robust)
        for k in (1, 2, 5, 17):
            stal = rng.integers(0, 6, size=k)
            msz = rng.integers(5, 400, size=k)
            c, c_w = got_rule.coefficients(stal, msz)
            jc, jc_w = want_rule.coefficients(stal, msz)
            assert c.dtype == np.float64
            assert c.tobytes() == jc.tobytes()
            assert type(c_w) is type(jc_w) and c_w == jc_w


def _toy_buffer(rng, k=5):
    updates = [{"w": torch.as_tensor(rng.normal(size=4).astype(np.float32))}
               for _ in range(k)]
    staleness = rng.integers(0, 4, size=k)
    n_samples = rng.integers(10, 50, size=k)
    g = {"w": torch.as_tensor(rng.normal(size=4).astype(np.float32))}
    return g, updates, staleness, n_samples


def _flush(rule, g, updates, staleness, n_samples, bases=None):
    """new = c_w*g + sum c_i*w_i (or the delta form) in float64."""
    c, c_w = rule.coefficients(np.asarray(staleness), np.asarray(n_samples))
    f64 = [u["w"].numpy().astype(np.float64) for u in updates]
    if rule.use_base:
        acc = sum(ci * (u - b["w"].numpy().astype(np.float64))
                  for ci, u, b in zip(c, f64, bases))
    else:
        acc = sum(ci * u for ci, u in zip(c, f64))
    return g["w"].numpy().astype(np.float64) * c_w + acc


@pytest.mark.parametrize("kw", RULE_KWARGS["fedasync"])
def test_fedasync_merge_reproduces_sequential_applies(kw):
    g, updates, staleness, n_samples = _toy_buffer(np.random.default_rng(0))
    got = _flush(ta.FedAsyncMerge(**kw), g, updates, staleness, n_samples)
    agg, seq = tagg.FedAsync(**kw), g
    for u, s, m in zip(updates, staleness, n_samples):
        seq = agg.apply(seq, tagg.ClientUpdate(u, n_samples=int(m),
                                               staleness=int(s)))
    np.testing.assert_allclose(got, seq["w"].numpy(), atol=1e-6)


@pytest.mark.parametrize("weight_by_samples", (False, True))
@pytest.mark.parametrize("server_lr", (1.0, 0.7))
def test_fedbuff_merge_reproduces_flush(server_lr, weight_by_samples):
    g, updates, staleness, n_samples = _toy_buffer(np.random.default_rng(1))
    rule = ta.FedBuffMerge(server_lr=server_lr,
                           weight_by_samples=weight_by_samples)
    got = _flush(rule, g, updates, staleness, n_samples)
    # a buffer one larger than the flush: the updates wait, then flush
    agg = tagg.FedBuff(buffer_size=len(updates) + 1, server_lr=server_lr,
                       weight_by_samples=weight_by_samples)
    for u, s, m in zip(updates, staleness, n_samples):
        assert agg.apply(g, tagg.ClientUpdate(u, n_samples=int(m),
                                              staleness=int(s))) is None
    np.testing.assert_allclose(got, agg.flush(g)["w"].numpy(), atol=1e-6)


@pytest.mark.parametrize("kw", RULE_KWARGS["delayed_grad"])
def test_delayed_gradient_merge_reproduces_sequential_applies(kw):
    rng = np.random.default_rng(2)
    g, updates, staleness, n_samples = _toy_buffer(rng)
    bases = [{"w": torch.as_tensor(rng.normal(size=4).astype(np.float32))}
             for _ in updates]
    got = _flush(ta.DelayedGradientMerge(**kw), g, updates, staleness,
                 n_samples, bases=bases)
    agg, seq = tagg.DelayedGradient(**kw), g
    for u, b, s, m in zip(updates, bases, staleness, n_samples):
        seq = agg.apply(seq, tagg.ClientUpdate(u, n_samples=int(m),
                                               staleness=int(s),
                                               base_params=b))
    np.testing.assert_allclose(got, seq["w"].numpy(), atol=1e-6)


def test_as_merge_rule_coerces_and_rejects_as_reference():
    assert type(as_merge_rule(None)) is ta.FedBuffMerge
    assert list(ASYNC_MERGES) == list(ja.ASYNC_MERGES)
    for name, factory in ASYNC_MERGES.items():
        rule, jrule = as_merge_rule(name), ja.as_merge_rule(name)
        assert isinstance(rule, getattr(factory, "func", factory))
        assert type(rule).__name__ == type(jrule).__name__
        assert rule.name == jrule.name == name
        assert vars(rule) == vars(jrule)
    rule = ta.FedAsyncMerge(mixing=0.2)
    assert as_merge_rule(rule) is rule
    streaming = [("FedAsync", dict(mixing=0.3, staleness_exponent=1.0)),
                 ("FedBuff", dict(server_lr=0.5, weight_by_samples=True,
                                  staleness_exponent=0.7)),
                 ("DelayedGradient", dict(server_lr=0.4,
                                          staleness_exponent=2.0)),
                 ("RobustAggregate", dict(method="krum", trim_frac=0.3,
                                          n_byzantine=2,
                                          weight_by_samples=False))]
    for cls, kw in streaming:
        rule = as_merge_rule(getattr(tagg, cls)(**kw))
        jrule = ja.as_merge_rule(getattr(jagg, cls)(**kw))
        assert type(rule).__name__ == type(jrule).__name__
        assert vars(rule) == vars(jrule)
    for bad, exc, match in (("fedsync", ValueError,
                             "unknown async merge rule"),
                            (object(), TypeError, "cannot derive"),
                            (tagg.SyncWeightedMean(), TypeError,
                             "cannot derive")):
        with pytest.raises(exc, match=match):
            as_merge_rule(bad)
    with pytest.raises(ValueError, match="unknown robust merge method"):
        ta.RobustMerge("mean")
    for bad in (lambda: ta.FedBuffMerge(server_lr=0.0),
                lambda: ta.FedAsyncMerge(mixing=1.5),
                lambda: ta.RobustMerge("median", server_lr=2.0)):
        with pytest.raises(ValueError):
            bad()


def test_fleet_config_carries_the_async_config():
    cfg = AsyncFleetConfig(epochs=3, batch_size=4, lr=0.1, use_kernel=False,
                           distance_free=False, materialize_below=64,
                           max_sweeps=7, weight_by_samples=False, seed=9,
                           cost=2.0)
    jcfg = ja.AsyncFleetConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
    got = dataclasses.asdict(cfg.fleet_config())
    want = dataclasses.asdict(jcfg.fleet_config())
    assert got == {**want, "aggregator": "weighted_mean"}
    assert [f.name for f in dataclasses.fields(AsyncFleetConfig)] == \
        [f.name for f in dataclasses.fields(ja.AsyncFleetConfig)]
    assert dataclasses.asdict(AsyncFleetConfig()) == \
        dataclasses.asdict(ja.AsyncFleetConfig())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["batched", "loop"])
@pytest.mark.parametrize("workload", ["mlp", "charlm", "xlstm", "cnn"])
def test_run_async_fleet_matches_reference(workload, engine, monkeypatch):
    jout, jrec = _reference(("engine", workload), workload, monkeypatch)
    rec = _recording(monkeypatch, ta)
    out = _port(workload, engine)
    check_against_reference(out, jout, workload, engine, jrec)
    check_medoids(rec, jrec)
    assert rec["groups"] == jrec["groups"]
    tel = out["telemetry"]
    # staleness > 0 merged, coresets built, and (batched) one dispatch a
    # group rather than a step
    assert tel["max_staleness"] >= 1
    assert sum(h.n_coreset for h in out["history"]) > 0
    assert sum(len(m) for m in rec["medoids"].values()) > 0
    if engine == "batched":
        assert 0 < tel["n_group_dispatches"] <= tel["n_dispatches"]


@pytest.mark.parametrize("name", list(ASYNC_MERGES))
def test_every_merge_rule_matches_reference(name, monkeypatch):
    jout, jrec = _reference(("rule", name), "mlp", monkeypatch,
                            cfg={"max_updates": 2}, aggregator=name)
    out = _port("mlp", cfg={"max_updates": 2}, aggregator=name)
    assert out["aggregator"] == name and out["applied"] == 2
    check_against_reference(out, jout, "mlp", "batched", jrec)


def test_partial_flush_at_cutoff_matches_reference(monkeypatch):
    """A ``max_virtual_time`` cutoff with a partly filled buffer: the tail
    merges as a partial flush."""
    jfull, _ = _reference(("engine", "mlp"), "mlp", monkeypatch)
    cut = jfull["telemetry"]["makespan"] * 0.6
    jout, jrec = _reference(("cut", "mlp"), "mlp", monkeypatch,
                            cfg={"max_virtual_time": cut})
    out = _port("mlp", cfg={"max_virtual_time": cut})
    tel = out["telemetry"]
    assert tel["n_partial_flushes"] == 1 and tel["makespan"] <= cut
    assert out["history"][-1].n_participants < CFG["buffer_k"]
    check_against_reference(out, jout, "mlp", "batched", jrec)


def test_forced_partial_flush_matches_reference(monkeypatch):
    """A buffer that cannot fill before the cutoff: exactly one partial
    flush carries all the work."""
    jfull, _ = _reference(("engine", "mlp"), "mlp", monkeypatch)
    cfg = {"buffer_k": 6, "concurrency": 6, "max_updates": 5,
           "max_virtual_time": jfull["telemetry"]["makespan"] * 0.4}
    jout, jrec = _reference(("forced", "mlp"), "mlp", monkeypatch, cfg=cfg)
    out = _port("mlp", cfg=cfg)
    tel = out["telemetry"]
    assert out["applied"] == tel["n_partial_flushes"] == 1
    assert 1 <= tel["n_merged_clients"] < 6
    check_against_reference(out, jout, "mlp", "batched", jrec)


@pytest.mark.parametrize("aggregator,faults", [
    ("fedbuff", None), ("delayed_grad", None), ("fedasync", None),
    ("trimmed_mean", "byzantine_signflip")])
def test_pinned_snapshots_stay_unchanged(aggregator, faults, monkeypatch):
    """Every dispatch snapshot a group trains from keeps its bytes to the
    end of the run, and one serves groups of two flushes (staleness > 0):
    no step of a flush writes into a tensor it was given."""
    seen = {}
    run_group = tb.FleetEngine.run_group

    def watching(self, params, group, batched=True):
        key = id(params)
        if key not in seen:
            seen[key] = (params, {k: v.clone() for k, v in params.items()},
                         set())
        _, before, flushes = seen[key]
        flushes.add(flushes_by_order[-1])
        for k, v in params.items():
            assert torch.equal(v, before[k]), k
        return run_group(self, params, group, batched)

    flushes_by_order = []
    groups = ta.make_cohort_groups

    def counting(*args, **kwargs):
        flushes_by_order.append(kwargs.get("round_seed"))
        return groups(*args, **kwargs)

    monkeypatch.setattr(tb.FleetEngine, "run_group", watching)
    monkeypatch.setattr(ta, "make_cohort_groups", counting)
    out = _port("mlp", aggregator=aggregator, faults=faults)
    assert out["telemetry"]["max_staleness"] >= 1
    assert any(len(f) >= 2 for _, _, f in seen.values())
    for params, before, _ in seen.values():
        for k, v in params.items():
            assert torch.equal(v, before[k]), k


def test_determinism_and_jsonl_schema():
    """Two runs: the same event log, records and parameter bytes; the
    port's JSONL passes the reference's schema, with the flush's
    spans."""
    sink = InMemorySink()
    with use_recorder(Recorder([sink])):
        a = _port("mlp")
    b = _port("mlp")
    assert a["event_log"] == b["event_log"]
    assert [dataclasses.astuple(r) for r in a["history"]] == \
        [dataclasses.astuple(r) for r in b["history"]]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
    validate_records(sink.records)
    spans = {r["name"] for r in sink.records if r["kind"] == "span"}
    assert {"round", "dispatch_wave", "buffer_fill", "cohort_build",
            "dispatch", "aggregate", "gather", "eval", "local_sgd",
            "coreset_group", "selection"} <= spans
    rounds = [r["data"] for r in sink.records
              if r["kind"] == "event" and r["name"] == "round"]
    assert [r["n_coreset"] for r in rounds] == \
        [h.n_coreset for h in a["history"]]
    assert all(r["runtime"] == "async_fleet" for r in rounds)
    run = [r for r in sink.records if r["kind"] == "run"][0]["data"]
    assert run["runtime"] == "async_fleet" and run["device"] == "cpu"

