"""The port's recorder: spans at the LM launcher's phases, k-medoids BUILD
and SWAP and the fleet's SGD steps, and the stream time (``dev_s``) they
carry where CUDA runs.

Recording on and off give bit-identical results; the LM's span tree is
the launcher's phases; ``kmedoids_swap`` stamps the sweeps its loop ran;
``dev_s`` is filled through the recorder's ``events`` seam only when the
outermost span ends, and is None without a card; with no recorder the
program asks the seam for nothing.  No timing is asserted.
"""
import numpy as np
import pytest
import torch

import repro_torch.core.kmedoids as km
import repro_torch.obs.recorder as rec_mod
from repro_torch.core.kmedoids import kmedoids_batched
from repro_torch.fed.fleet import (FleetConfig, FleetEngine, get_workload,
                                   make_cohort_groups)
from repro_torch.launch.train import PRESETS, train_fedcore_lm
from repro_torch.obs import (InMemorySink, Recorder, use_recorder,
                             validate_records)

# 4 silos of 16 sequences, 30 % stragglers: seed 4 makes silo 0 the one
# straggler, with a budget of 8 that no floor raises (the launcher's
# deadline holds)
LM = dict(rounds=2, steps_per_epoch=4, silos=4, batch=4, seq=16, lr=0.05,
          straggler_pct=30.0, seed=4, device="cpu")
FLEET_CFG = dict(epochs=3, batch_size=8, lr=0.05, seed=0)


def _spans(records):
    return [r for r in records if r["kind"] == "span"]


def _tree(records):
    """[(name, attrs without sweeps, children)] of the outermost spans."""
    spans = _spans(records)
    kids = {}
    for sp in spans:
        kids.setdefault(sp["parent"], []).append(sp)

    def node(sp):
        attrs = {k: v for k, v in sp["attrs"].items() if k != "sweeps"}
        return (sp["name"], attrs, [node(c) for c in kids.get(sp["sid"], [])])
    return [node(sp) for sp in kids.get(None, [])]


def _lm(recorded: bool):
    torch.set_num_threads(2)
    sink = InMemorySink()
    if recorded:
        with use_recorder(Recorder([sink])):
            out = train_fedcore_lm(PRESETS["tiny"], **LM)
    else:
        out = train_fedcore_lm(PRESETS["tiny"], **LM)
    return out, sink.records


@pytest.fixture(scope="module")
def lm_runs():
    return _lm(False), _lm(True)


def _fleet_group():
    wl = get_workload("mlp")
    clients = wl.make_clients(n_clients=6, seed=0, mean_samples=24.0,
                              std_samples=8.0)
    cfg = FleetConfig(**FLEET_CFG)
    groups = make_cohort_groups(clients, list(range(6)),
                                {c: 4 for c in range(6)}, cfg)
    group = next(g for g in groups if g.k > 0 and g.n_clients > 1)
    params = wl.init(torch.Generator().manual_seed(0), "cpu")
    return FleetEngine(wl, cfg, device="cpu"), group, params


def test_lm_recording_on_and_off_bit_identical(lm_runs):
    (off, _), (on, _) = lm_runs
    assert on["history"] == off["history"]
    assert on["coresets"] == off["coresets"]
    assert set(on["params"]) == set(off["params"])
    assert all(torch.equal(on["params"][k], off["params"][k])
               for k in off["params"])


def test_lm_span_tree_is_the_launchers_phases(lm_runs):
    (out, _), (_, records) = lm_runs
    validate_records(records)
    (straggler,) = out["coresets"][0]
    k = len(out["coresets"][0][straggler])
    assert straggler == 0 and k == 8
    m, spe = LM["steps_per_epoch"] * LM["batch"], LM["steps_per_epoch"]
    solve = [("kmedoids_build", {"n_clients": 1, "m": m, "k": k}, []),
             ("kmedoids_swap", {"n_clients": 1, "m": m, "k": k}, [])]
    group = ("coreset_group", {"silo": 0, "k": k}, [
        ("grad_features", {}, []), ("selection", {}, solve),
        ("sgd_steps", {"steps": spe}, []),
        ("coreset_epochs", {"steps": 1}, [])])
    full = [("local_sgd", {"silo": s}, [("sgd_steps", {"steps": 2 * spe},
                                         [])]) for s in (1, 2, 3)]
    want = [("lm_init", {}, [])] + [
        ("round", {"round": r}, [group] + full + [("aggregate", {}, [])])
        for r in range(LM["rounds"])]
    assert _tree(records) == want
    swaps = [sp for sp in _spans(records) if sp["name"] == "kmedoids_swap"]
    assert all(isinstance(sp["attrs"]["sweeps"], int)
               and 1 <= sp["attrs"]["sweeps"] <= 50 for sp in swaps)
    # no card: no stream time, and every record emitted in end order
    assert all(sp["dev_s"] is None for sp in _spans(records))
    ends = [sp["t1"] for sp in _spans(records)]
    assert ends == sorted(ends)


def test_fleet_straggler_group_recording_on_and_off_bit_identical():
    torch.set_num_threads(2)
    engine, group, params = _fleet_group()
    p_off, loss_off, med_off = engine.run_group(params, group)
    sink = InMemorySink()
    with use_recorder(Recorder([sink])):
        p_on, loss_on, med_on = engine.run_group(params, group)
    assert all(torch.equal(p_on[k], p_off[k]) for k in p_off)
    assert np.array_equal(loss_on, loss_off)
    assert np.array_equal(med_on, med_off)
    validate_records(sink.records)
    c, kk = group.n_clients, group.k
    steps = group.valid.shape[1] // FLEET_CFG["batch_size"]
    solve = [("kmedoids_build", {"n_clients": c,
                                 "m": group.valid.shape[1], "k": kk}, []),
             ("kmedoids_swap", {"n_clients": c,
                                "m": group.valid.shape[1], "k": kk}, [])]
    assert _tree(sink.records) == [("coreset_group",
                                    {"k": kk, "n_clients": c}, [
        ("grad_features", {"k": kk, "n_clients": c}, []),
        ("selection", {"k": kk, "n_clients": c}, solve),
        ("sgd_steps", {"steps": steps, "n_clients": c,
                       "graphed": False}, []),
        ("coreset_epochs", {"steps": FLEET_CFG["epochs"] - 1,
                            "n_clients": c, "graphed": False}, [])])]


@pytest.mark.parametrize("seed,max_sweeps", [
    (1, 50),     # BUILD already optimal: one sweep finds no better swap
    (9, 50),     # five sweeps to converge
    (9, 2),      # cut at max_sweeps
    (9, 0)])     # no sweep at all
def test_swap_span_stamps_the_sweeps_its_loop_ran(monkeypatch, seed,
                                                  max_sweeps):
    x = torch.randn(24, 3, generator=torch.Generator().manual_seed(seed))
    D = torch.cdist(x, x)[None]
    valid = torch.ones(1, 24, dtype=torch.bool)
    build = kmedoids_batched(D, valid, 4, max_sweeps=0).medoids
    calls = []
    inner = km.kmedoids_delta_sweep

    def counted(*a, **kw):        # one delta sweep a SWAP sweep
        calls.append(1)
        return inner(*a, **kw)
    monkeypatch.setattr(km, "kmedoids_delta_sweep", counted)
    sink = InMemorySink()
    with use_recorder(Recorder([sink])):
        res = kmedoids_batched(D, valid, 4, max_sweeps=max_sweeps)
    (swap,) = [sp for sp in _spans(sink.records)
               if sp["name"] == "kmedoids_swap"]
    assert swap["attrs"]["sweeps"] == len(calls) <= max_sweeps
    if seed == 1:
        assert torch.equal(res.medoids, build) and len(calls) == 1
    elif max_sweeps:
        assert len(calls) == min(5, max_sweeps)
    else:
        assert len(calls) == 0 and torch.equal(res.medoids, build)


class Marks:
    """Stand-in stream markers: each records the next tick of a fake
    stream; reading two needs the later one waited on."""

    def __init__(self):
        self.made, self.waits, self.tick = 0, 0, 0

    def __call__(self):
        self.made += 1
        self.tick += 1
        return Mark(self, self.tick)


class Mark:
    def __init__(self, marks, tick):
        self.marks, self.tick, self.done = marks, tick, False

    def synchronize(self):
        self.marks.waits += 1
        self.done = True

    def elapsed_time(self, other):           # ms, as CUDA events give
        assert other.done
        return 1e3 * (other.tick - self.tick)


def test_dev_s_filled_through_the_event_seam_when_the_outermost_ends():
    marks, sink = Marks(), InMemorySink()
    rec = Recorder([sink], events=marks)
    with rec.span("round"):                 # mark 1 .. 6
        with rec.span("sgd_steps", steps=3):        # 2, 3
            pass
        rec.event("note", x=1)
        with rec.span("selection"):                 # 4, 5
            assert marks.waits == 0 and sink.records == []
    assert marks.made == 6 and marks.waits == 3
    assert [(r["kind"], r.get("name"), r.get("dev_s")) for r in sink.records
            ] == [("span", "sgd_steps", 1.0), ("event", "note", None),
                  ("span", "selection", 1.0), ("span", "round", 5.0)]
    seqs = [r["seq"] for r in sink.records]
    assert seqs == sorted(seqs)
    validate_records(sink.records)
    # flush_metrics emits what an open span holds, then the metrics
    outer = rec.span_begin("round")
    with rec.span("aggregate"):
        pass
    rec.flush_metrics()
    assert [r.get("name", r["kind"]) for r in sink.records[4:]] == [
        "aggregate", "metrics"]
    rec.span_end(outer)
    assert sink.records[-1]["name"] == "round"
    assert sink.records[-1]["dev_s"] == 3.0


def test_no_stream_time_without_a_card_or_without_sinks():
    sink = InMemorySink()
    rec = Recorder([sink])
    with rec.span("round"):
        with rec.span("selection"):
            pass
        assert [r["name"] for r in sink.records] == ["selection"]
    assert all(r["dev_s"] is None for r in sink.records)
    marks = Marks()
    with Recorder([], events=marks).span("round"):
        pass
    assert marks.made == 0


def test_no_recorder_asks_the_seam_for_nothing(monkeypatch):
    """With no recorder installed the instrumented code makes no marker
    and waits on none; a recorder made afterwards uses the same seam."""
    torch.set_num_threads(2)
    marks = Marks()
    monkeypatch.setattr(rec_mod, "cuda_event", marks)
    engine, group, params = _fleet_group()
    engine.run_group(params, group)
    train_fedcore_lm(PRESETS["tiny"], **dict(LM, rounds=1))
    assert marks.made == 0 and marks.waits == 0
    with use_recorder(Recorder([InMemorySink()])):
        engine.run_group(params, group)
    assert marks.made > 0 and marks.waits > 0


def _profiled_spans(rec):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("round"):
            with rec.span("sgd_steps", steps=1):
                torch.ones(3).add_(1.0)
    return {e.name(): e.activity_type()
            for e in prof.profiler.kineto_results.events()
            if e.name() in ("round", "sgd_steps")}


def test_annotated_spans_are_profiler_ranges_of_their_names(monkeypatch):
    """Each span is a range of its name on the host's timeline: a
    user-scope range where the profiler's events carry an activity type,
    else one of the function scope, which the profiler does not draw on
    the device's timeline beside the kernels."""
    assert _profiled_spans(Recorder([], annotate=True)) == {
        "round": "user_annotation", "sgd_steps": "user_annotation"}

    class NoKind:
        pass
    with monkeypatch.context() as mp:
        mp.setattr(torch._C._autograd, "_KinetoEvent", NoKind)
        ranges = [rec_mod._profiler_range(n) for n in ("round", "sgd_steps")]
    assert all(type(r).__name__ == "RecordFunctionFast" for r in ranges)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ranges[0], ranges[1]:
            torch.ones(3).add_(1.0)
    assert {e.name(): e.activity_type()
            for e in prof.profiler.kineto_results.events()
            if e.name() in ("round", "sgd_steps")} == {
        "round": "cpu_op", "sgd_steps": "cpu_op"}
