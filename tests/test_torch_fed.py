"""The slice as a whole: the port's FedCore sync round against the JAX one.

For each paper model, a 3-round ``run_federated`` with the ``FedCore``
strategy runs in both packages on the same client data, the same
converted initial weights and the same numpy seed.  The cohorts, the
coreset indices of every (round, client), the ``RoundRecord`` timing and
violation fields must be equal, and the final parameters within the
reference's conformance tolerance (``PARAMS_ATOL`` of
``tests/test_workload_conformance.py``: 2e-4 for the CNN, whose
first-conv gradient the frameworks lower differently, 1e-5 otherwise).

The clients hold equal sample counts and fixed capabilities chosen so
that the stragglers' budgets (1 and 6 of 30) leave no near-tied medoid
choice: XLA and PyTorch round the float32 distance cross term
differently (about 1e-5 absolute), and a budget close to m turns such
rounding into a different but equally good coreset (see
``tests/test_torch_kmedoids.py`` for the tie rule).
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

import repro.fed.strategies as jstrat  # noqa: E402
from repro.data import (  # noqa: E402
    mnist_like_dataset, shakespeare_like_dataset, synthetic_dataset)
from repro.fed.server import FLConfig as JFLConfig  # noqa: E402
from repro.fed.server import run_federated as j_run_federated  # noqa: E402
from repro.fed.simulator import ClientSpec as JClientSpec  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro.obs.schema import validate_records  # noqa: E402
import torch  # noqa: E402

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fed import (ClientSpec, FedAvg, FedAvgDS,  # noqa: E402
                             FedCore, FedProx, FLConfig, LocalTrainer,
                             run_federated)
from repro_torch.models import small as tsmall  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    JSONLSink, Recorder, read_jsonl, use_recorder)

torch.set_num_threads(1)

PARAMS_ATOL = {"cnn": 2e-4}
M = 30
CAPS = (1.0, 0.3, 0.8, 1.2, 0.25, 0.9)
CFG = dict(rounds=3, clients_per_round=3, epochs=3, batch_size=8, lr=0.05,
           seed=2, straggler_pct=40.0)


def _data(name):
    n = len(CAPS)
    if name == "logreg":
        clients = synthetic_dataset(0.5, 0.5, n_clients=n,
                                    mean_samples=3 * M, std_samples=1, seed=1)
    elif name == "cnn":
        clients = mnist_like_dataset(n_clients=n, mean_samples=3 * M,
                                     std_samples=1, size=14, seed=1)
    else:   # non-overlapping windows: no near-duplicate samples
        clients = [{k: v[::12] for k, v in d.items()}
                   for d in shakespeare_like_dataset(
                       n_clients=n, mean_samples=13 * M, std_samples=1,
                       seq_len=12, seed=1)]
    return [{k: v[:M] for k, v in d.items()} for d in clients]


def _models(name):
    if name == "logreg":
        return jsmall.LogisticRegression(), tsmall.LogisticRegression()
    if name == "cnn":
        return (jsmall.SmallCNN(image_size=14, channels=(4, 8)),
                tsmall.SmallCNN(image_size=14, channels=(4, 8)))
    return (jsmall.CharLSTM(d_hidden=16, n_layers=1),
            tsmall.CharLSTM(d_hidden=16, n_layers=1))


def _init(name, jm):
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if name == "logreg":          # the reference's zero init, perturbed
        rng = np.random.default_rng(5)
        jp = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in jp.items()}
    return jp


class RecordingFedCore(FedCore):
    """FedCore that keeps every selected coreset, in selection order."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.selected = []

    def select_coreset(self, feats, budget):
        cs = super().select_coreset(feats, budget)
        self.selected.append(cs.indices.cpu().numpy())
        return cs


@pytest.mark.parametrize("name", ["logreg", "cnn", "charlm"])
def test_fedcore_round_matches_reference(name, monkeypatch):
    jm, tm = _models(name)
    train = _data(name)
    jp = _init(name, jm)

    j_selected = []
    build = jstrat.build_coreset

    def recording_build(feats, budget, **kwargs):
        cs = build(feats, budget, **kwargs)
        j_selected.append(np.asarray(cs.indices))
        return cs

    monkeypatch.setattr(jstrat, "build_coreset", recording_build)
    jout = j_run_federated(
        jm, train, [JClientSpec(i, M, c) for i, c in enumerate(CAPS)],
        jstrat.FedCore(jstrat.LocalTrainer(jm, CFG["lr"], CFG["batch_size"])),
        JFLConfig(**CFG), init_params=jp)

    strategy = RecordingFedCore(LocalTrainer(tm, CFG["lr"], CFG["batch_size"],
                                             device="cpu"))
    tout = run_federated(
        tm, train, [ClientSpec(i, M, c) for i, c in enumerate(CAPS)],
        strategy, FLConfig(**CFG),
        init_params=params_from_jax(name, jp, device="cpu"), device="cpu")

    # the coreset path ran, with a k = 1 and a k > 1 budget
    assert sum(h.n_coreset for h in tout["history"]) >= 3
    assert {len(s) for s in strategy.selected} >= {1, 6}
    assert len(strategy.selected) == len(j_selected)
    for got, want in zip(strategy.selected, j_selected):
        np.testing.assert_array_equal(got, want)
    assert tout["deadline"] == jout["deadline"]
    for a, b in zip(tout["history"], jout["history"]):
        assert a.sim_round_time == b.sim_round_time
        assert a.client_times == b.client_times
        assert a.n_coreset == b.n_coreset
        assert a.n_violations == b.n_violations
        assert a.n_participants == b.n_participants
    want = params_from_jax(name, jax.tree.map(np.asarray, jout["params"]),
                           device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(tout["params"][k].numpy(), v.numpy(),
                                   atol=PARAMS_ATOL.get(name, 1e-5),
                                   err_msg=k)


@pytest.mark.parametrize("strategy", ["fedavg", "fedavg_ds", "fedprox"])
def test_baseline_strategies_match_reference(strategy):
    """FedAvg, FedAvg-DS (stragglers dropped) and FedProx (partial work
    plus the proximal term) on the convex model."""
    jm, tm = _models("logreg")
    train = _data("logreg")
    jp = _init("logreg", jm)
    j_cls = {"fedavg": jstrat.FedAvg, "fedavg_ds": jstrat.FedAvgDS,
             "fedprox": jstrat.FedProx}[strategy]
    t_cls = {"fedavg": FedAvg, "fedavg_ds": FedAvgDS,
             "fedprox": FedProx}[strategy]
    mu = 0.1 if strategy == "fedprox" else 0.0
    jout = j_run_federated(
        jm, train, [JClientSpec(i, M, c) for i, c in enumerate(CAPS)],
        j_cls(jstrat.LocalTrainer(jm, CFG["lr"], CFG["batch_size"],
                                  prox_mu=mu)),
        JFLConfig(**CFG), init_params=jp)
    tout = run_federated(
        tm, train, [ClientSpec(i, M, c) for i, c in enumerate(CAPS)],
        t_cls(LocalTrainer(tm, CFG["lr"], CFG["batch_size"], prox_mu=mu,
                           device="cpu")),
        FLConfig(**CFG), init_params=params_from_jax("logreg", jp,
                                                     device="cpu"),
        device="cpu")
    for a, b in zip(tout["history"], jout["history"]):
        assert (a.sim_round_time, a.client_times, a.n_dropped,
                a.n_violations, a.n_participants) == \
            (b.sim_round_time, b.client_times, b.n_dropped,
             b.n_violations, b.n_participants)
        np.testing.assert_allclose(a.train_loss, b.train_loss, atol=1e-5)
    want = params_from_jax("logreg", jax.tree.map(np.asarray,
                                                  jout["params"]),
                           device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(tout["params"][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)


def test_faults_none_matches_reference():
    """``faults="none"``, the reference registry's no-fault profile, runs
    the sync round as ``faults=None`` does: the same run as the
    reference's under ``"none"``, and bit for bit the port's under
    None."""
    jm, tm = _models("logreg")
    train = _data("logreg")
    jp = _init("logreg", jm)
    jout = j_run_federated(
        jm, train, [JClientSpec(i, M, c) for i, c in enumerate(CAPS)],
        jstrat.FedCore(jstrat.LocalTrainer(jm, CFG["lr"], CFG["batch_size"])),
        JFLConfig(**CFG), init_params=jp, faults="none")
    outs = {}
    for faults in ("none", None):
        outs[faults] = run_federated(
            tm, train, [ClientSpec(i, M, c) for i, c in enumerate(CAPS)],
            FedCore(LocalTrainer(tm, CFG["lr"], CFG["batch_size"],
                                 device="cpu")),
            FLConfig(**CFG), init_params=params_from_jax("logreg", jp,
                                                         device="cpu"),
            faults=faults, device="cpu")
    tout = outs["none"]
    assert tout["faults"] == jout["faults"] == "none"
    assert sum(h.n_coreset for h in tout["history"]) > 0
    for a, b, c in zip(tout["history"], jout["history"],
                       outs[None]["history"]):
        assert (a.sim_round_time, a.client_times, a.n_dropped,
                a.n_coreset, a.n_participants) == \
            (b.sim_round_time, b.client_times, b.n_dropped, b.n_coreset,
             b.n_participants)
        np.testing.assert_allclose(a.train_loss, b.train_loss, atol=1e-5)
        assert a.train_loss == c.train_loss
    want = params_from_jax("logreg", jax.tree.map(np.asarray,
                                                  jout["params"]),
                           device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(tout["params"][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)
        assert torch.equal(tout["params"][k], outs[None]["params"][k])


@pytest.mark.parametrize("faults,aggregator", [("dropout", "weighted_mean"),
                                               ("byzantine_boost",
                                                "norm_clip")])
def test_faults_and_robust_aggregator_match_reference(faults, aggregator):
    """A fault profile and a robust aggregator on the sync round: the
    same dropped counts, timing and parameters as the reference's."""
    jm, tm = _models("logreg")
    train = _data("logreg")
    jp = _init("logreg", jm)
    jout = j_run_federated(
        jm, train, [JClientSpec(i, M, c) for i, c in enumerate(CAPS)],
        jstrat.FedAvg(jstrat.LocalTrainer(jm, CFG["lr"], CFG["batch_size"])),
        JFLConfig(**CFG), init_params=jp, faults=faults,
        aggregator=aggregator)
    tout = run_federated(
        tm, train, [ClientSpec(i, M, c) for i, c in enumerate(CAPS)],
        FedAvg(LocalTrainer(tm, CFG["lr"], CFG["batch_size"],
                            device="cpu")),
        FLConfig(**CFG), init_params=params_from_jax("logreg", jp,
                                                     device="cpu"),
        faults=faults, aggregator=aggregator, device="cpu")
    assert (tout["faults"], tout["aggregator"]) == (faults, aggregator)
    for a, b in zip(tout["history"], jout["history"]):
        assert (a.sim_round_time, a.client_times, a.n_dropped,
                a.n_participants) == \
            (b.sim_round_time, b.client_times, b.n_dropped,
             b.n_participants)
    if faults == "dropout":
        assert sum(h.n_dropped for h in tout["history"]) > 0
    want = params_from_jax("logreg", jax.tree.map(np.asarray,
                                                  jout["params"]),
                           device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(tout["params"][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)


def test_port_jsonl_passes_reference_schema(tmp_path):
    jm, tm = _models("logreg")
    train = _data("logreg")
    path = tmp_path / "run.jsonl"
    rec = Recorder([JSONLSink(str(path))], annotate=True)
    with use_recorder(rec):
        out = run_federated(
            tm, train, [ClientSpec(i, M, c) for i, c in enumerate(CAPS)],
            FedCore(LocalTrainer(tm, 0.05, 8, device="cpu")),
            FLConfig(**CFG), test_data=train[0],
            init_params=params_from_jax("logreg", _init("logreg", jm),
                                        device="cpu"),
            device="cpu")
    rec.close()
    records = read_jsonl(str(path))
    validate_records(records)
    names = {r["name"] for r in records if r["kind"] == "span"}
    assert {"round", "cohort_select", "local_update", "grad_features",
            "selection", "local_sgd", "coreset_epochs", "aggregate",
            "eval"} <= names
    rounds = [r for r in records
              if r["kind"] == "event" and r["name"] == "round"]
    assert [r["data"]["n_coreset"] for r in rounds] == \
        [h.n_coreset for h in out["history"]]
    assert all(r["attrs"]["device"] == "cpu" for r in records
               if r["kind"] == "span" and r["name"] == "selection")
