"""The JL projection, exact per-sample gradients and the ε audit against
the JAX package's.

``project_features`` is a no-op at ``dim >= F`` and otherwise multiplies
by the (F, dim) matrix ``jl_matrix`` draws.  The JAX package draws its
matrix from ``jax.random``, which torch cannot replay, so the parity
tests put the JAX matrix in the port's place (``_jax_matrix``): then
``build_coreset(projection_dim=)`` picks the reference's medoids, and a
FedCore ``run_federated`` with ``FedCoreConfig(projection_dim=)`` gives
the reference's coresets per (round, client) and round records (the
clients of ``tests/test_torch_fed.py``, whose budgets leave no near-tie
at these projections).  ``true_per_sample_grads`` matches the
reference's column for column (JAX leaf order and layout) on
``LogisticRegression`` and a small ``SmallCNN`` at atol 1e-5;
``coreset_epsilon`` matches the reference's ε, and the reference's
monotone-ε and random-subset assertions (``tests/test_coreset.py``)
hold on the port.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fed.strategies as jstrat  # noqa: E402
from repro.core import coreset as jcoreset  # noqa: E402
from repro.core import gradients as jgradients  # noqa: E402
from repro.data import mnist_like_dataset, synthetic_dataset  # noqa: E402
from repro.fed.server import FLConfig as JFLConfig  # noqa: E402
from repro.fed.server import run_federated as j_run_federated  # noqa: E402
from repro.fed.simulator import ClientSpec as JClientSpec  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
import torch  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import coreset as tcoreset  # noqa: E402
from repro_torch.core import gradients as tgradients  # noqa: E402
from repro_torch.core import kmedoids as tk  # noqa: E402
from repro_torch.fed import (ClientSpec, FedCore, FLConfig,  # noqa: E402
                             LocalTrainer, run_federated)
from repro_torch.models import small as tsmall  # noqa: E402

torch.set_num_threads(1)


def _jax_matrix(f, dim, seed, dtype, device):
    """The reference's JL matrix (``repro.core.gradients.project_features``
    draws it so), as ``jl_matrix`` returns one."""
    proj = (jax.random.normal(jax.random.PRNGKey(seed), (f, dim), jnp.float32)
            / jnp.sqrt(dim))
    return torch.tensor(np.asarray(proj)).to(device=device, dtype=dtype)


def _clusters(seed, m, d, n_clusters=6):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 6.0
    x = centers[rng.integers(0, n_clusters, size=m)] + rng.normal(size=(m, d))
    return x.astype(np.float32)


def test_project_features_noop_and_shape():
    x = torch.as_tensor(_clusters(0, 30, 12))
    assert tgradients.project_features(x, 12) is x
    assert tgradients.project_features(x, 40) is x
    y = tgradients.project_features(x, 5)
    assert y.shape == (30, 5) and y.dtype == torch.float32
    p = tgradients.jl_matrix(12, 5, 0, torch.float32, torch.device("cpu"))
    assert torch.equal(y, x @ p)
    # seeded: the same matrix every call, another for another seed
    assert torch.equal(tgradients.project_features(x, 5), y)
    assert not torch.equal(tgradients.project_features(x, 5, seed=1), y)
    # N(0, 1) / sqrt(dim): the columns' mean square near 1 / dim
    big = tgradients.jl_matrix(4096, 16, 3, torch.float32,
                               torch.device("cpu"))
    assert abs(float((big ** 2).mean()) * 16 - 1.0) < 0.05


def test_project_features_matches_reference_under_its_matrix(monkeypatch):
    monkeypatch.setattr(tgradients, "jl_matrix", _jax_matrix)
    x = _clusters(1, 50, 64)
    for dim in (8, 32):
        want = np.asarray(jgradients.project_features(jnp.asarray(x), dim))
        got = tgradients.project_features(torch.as_tensor(x), dim).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,m,k,dim", [(2, 60, 6, 16), (3, 45, 9, 8)])
def test_build_coreset_projection_matches_reference(seed, m, k, dim,
                                                    monkeypatch):
    monkeypatch.setattr(tgradients, "jl_matrix", _jax_matrix)
    x = _clusters(seed, m, 64)
    want = jcoreset.build_coreset(jnp.asarray(x), k, projection_dim=dim)
    got = tcoreset.build_coreset(torch.as_tensor(x), k, projection_dim=dim)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    # the f64 objective on the projected features agrees as well
    feats = tgradients.project_features(torch.as_tensor(x), dim).numpy()
    assert tk.medoid_objective_f64(feats, got.indices.numpy()) == \
        pytest.approx(float(want.objective), rel=1e-5)


M = 30
CAPS = (1.0, 0.3, 0.8, 1.2, 0.25, 0.9)
CFG = dict(rounds=3, clients_per_round=3, epochs=3, batch_size=8, lr=0.05,
           seed=2, straggler_pct=40.0)


def _fl_case(name):
    """The clients, models and init of ``tests/test_torch_fed.py``."""
    n = len(CAPS)
    if name == "logreg":
        clients = synthetic_dataset(0.5, 0.5, n_clients=n,
                                    mean_samples=3 * M, std_samples=1, seed=1)
        jm, tm = jsmall.LogisticRegression(), tsmall.LogisticRegression()
    else:
        clients = mnist_like_dataset(n_clients=n, mean_samples=3 * M,
                                     std_samples=1, size=14, seed=1)
        jm = jsmall.SmallCNN(image_size=14, channels=(4, 8))
        tm = tsmall.SmallCNN(image_size=14, channels=(4, 8))
    train = [{k: v[:M] for k, v in d.items()} for d in clients]
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if name == "logreg":          # the reference's zero init, perturbed
        rng = np.random.default_rng(5)
        jp = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in jp.items()}
    return train, jm, tm, jp


class RecordingFedCore(FedCore):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.selected = []

    def select_coreset(self, feats, budget):
        cs = super().select_coreset(feats, budget)
        self.selected.append(cs.indices.cpu().numpy())
        return cs


@pytest.mark.parametrize("name,dim", [("logreg", 16), ("cnn", 24)])
def test_fedcore_projection_round_matches_reference(name, dim, monkeypatch):
    monkeypatch.setattr(tgradients, "jl_matrix", _jax_matrix)
    train, jm, tm, jp = _fl_case(name)
    j_selected = []
    build = jstrat.build_coreset

    def recording_build(feats, budget, **kwargs):
        assert kwargs["projection_dim"] == dim
        cs = build(feats, budget, **kwargs)
        j_selected.append(np.asarray(cs.indices))
        return cs

    monkeypatch.setattr(jstrat, "build_coreset", recording_build)
    jout = j_run_federated(
        jm, train, [JClientSpec(i, M, c) for i, c in enumerate(CAPS)],
        jstrat.FedCore(jstrat.LocalTrainer(jm, CFG["lr"], CFG["batch_size"]),
                       jcoreset.FedCoreConfig(projection_dim=dim)),
        JFLConfig(**CFG), init_params=jp)
    strategy = RecordingFedCore(
        LocalTrainer(tm, CFG["lr"], CFG["batch_size"], device="cpu"),
        tcoreset.FedCoreConfig(projection_dim=dim))
    tout = run_federated(
        tm, train, [ClientSpec(i, M, c) for i, c in enumerate(CAPS)],
        strategy, FLConfig(**CFG),
        init_params=params_from_jax(name, jp, device="cpu"), device="cpu")

    assert len(strategy.selected) == len(j_selected) >= 3
    for got, want in zip(strategy.selected, j_selected):
        np.testing.assert_array_equal(got, want)
    for a, b in zip(tout["history"], jout["history"]):
        assert a.sim_round_time == b.sim_round_time
        assert a.client_times == b.client_times
        assert a.n_coreset == b.n_coreset
        assert a.n_violations == b.n_violations
        assert a.n_participants == b.n_participants
        assert abs(a.train_loss - b.train_loss) <= 2e-4


def _logreg_client(seed=0, m=120, d=10, classes=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.normal(size=(d, classes))
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return {"x": x, "y": y}


def _image_client(m=40, size=8, classes=3):
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(m, size, size)).astype(np.float32)
    labels = (imgs.mean(axis=(1, 2)) > 0).astype(np.int32) % classes
    return {"x": imgs, "y": labels}


def _perturbed(jp, seed):
    rng = np.random.default_rng(seed)
    return {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in jp.items()}


@pytest.mark.parametrize("name", ["logreg", "cnn"])
def test_true_per_sample_grads_match_reference(name):
    if name == "logreg":
        jm = jsmall.LogisticRegression(n_features=10, n_classes=4)
        tm = tsmall.LogisticRegression(n_features=10, n_classes=4)
        data, batch = _logreg_client(m=50), 16
    else:
        jm = jsmall.SmallCNN(image_size=8, channels=(4, 8), n_classes=3)
        tm = tsmall.SmallCNN(image_size=8, channels=(4, 8), n_classes=3)
        data, batch = _image_client(), 40
    jp = _perturbed(jax.tree.map(np.asarray,
                                 jm.init(jax.random.PRNGKey(2))), 4)
    want = jgradients.true_per_sample_grads(
        jm.loss, jp, {k: jnp.asarray(v) for k, v in data.items()},
        batch_size=batch)
    got = tcore.true_per_sample_grads(
        tm.loss, params_from_jax(name, jp, device="cpu"), data,
        batch_size=batch)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1] == sum(v.size for v in jp.values())
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    # another chunking gives the same matrix
    again = tcore.true_per_sample_grads(
        tm.loss, params_from_jax(name, jp, device="cpu"), data,
        batch_size=7)
    np.testing.assert_allclose(again, got, rtol=0, atol=1e-6)


def test_epsilon_matches_reference_and_decreases_with_budget():
    """The ε of Assumption A.3 on exact per-sample gradients: the
    reference's value for the same coreset, exact at the full budget,
    shrinking with the budget, and below a random subset's."""
    data = _logreg_client(m=90)
    jm = jsmall.LogisticRegression(n_features=10, n_classes=4)
    tm = tsmall.LogisticRegression(n_features=10, n_classes=4)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tp = params_from_jax("logreg", jp, device="cpu")
    grads = tcore.true_per_sample_grads(tm.loss, tp, data)
    jgrads = np.asarray(jgradients.true_per_sample_grads(
        jm.loss, jp, {k: jnp.asarray(v) for k, v in data.items()}))
    np.testing.assert_allclose(grads, jgrads, rtol=0, atol=1e-5)
    feats = tcore.grad_features(tm, tp, data)
    eps = []
    for b in (3, 10, 30, 90):
        cs = tcore.build_coreset(feats, b)
        eps.append(float(tcore.coreset_epsilon(grads, cs)))
        jcs = jcoreset.build_coreset(jnp.asarray(data["x"]), b)
        # at b = m every sample is a medoid, the slots in any order
        order = np.sort if b == 90 else np.asarray
        np.testing.assert_array_equal(order(cs.indices.numpy()),
                                      order(np.asarray(jcs.indices)))
        want = float(jcoreset.coreset_epsilon(jnp.asarray(jgrads), jcs))
        assert eps[-1] == pytest.approx(want, rel=1e-4, abs=1e-7)
    assert eps[-1] < 1e-6           # the full-budget coreset is exact
    assert eps[0] > eps[2]          # monotone-ish improvement
    rng = np.random.default_rng(0)
    rand_eps = []
    for _ in range(5):
        idx = rng.choice(90, size=10, replace=False)
        approx = grads[idx].sum(0) * (90 / 10)
        rand_eps.append(np.linalg.norm(grads.sum(0) - approx) / 90)
    cs10 = tcore.build_coreset(feats, 10)
    assert float(tcore.coreset_epsilon(torch.as_tensor(grads), cs10)) < \
        np.mean(rand_eps) * 1.5


def test_core_exports_the_reference_names():
    import repro.core as jcore

    want = {n for n in dir(jcore) if not n.startswith("_")}
    got = {n for n in dir(tcore) if not n.startswith("_")}
    assert want <= got, want - got
