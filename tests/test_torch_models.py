"""The port's paper models, train step and helpers against the JAX package.

For each model, on JAX-initialised weights carried over by
``repro_torch.convert``: logits, the weighted loss, the §4.3 gradient
features and one SGD step (FedProx term on) agree at atol 1e-5 — the
two frameworks sum in float32 in different orders.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import small as jsmall  # noqa: E402
from repro.models.training import make_train_step as j_make_step  # noqa: E402
from repro.optim.optimizers import sgd as j_sgd  # noqa: E402
from repro.utils.tree import tree_weighted_mean as j_twm  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.gradients import grad_features  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402
from repro_torch.models.training import make_train_step  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.utils.tree import tree_weighted_mean  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5
B = 6


def _case(name):
    rng = np.random.default_rng(3)
    if name == "logreg":
        jm, tm = jsmall.LogisticRegression(), tsmall.LogisticRegression()
        x = rng.normal(size=(B, 60)).astype(np.float32)
        y = rng.integers(0, 10, size=B).astype(np.int32)
    elif name == "cnn":
        jm = jsmall.SmallCNN(image_size=14, channels=(4, 8))
        tm = tsmall.SmallCNN(image_size=14, channels=(4, 8))
        x = rng.normal(size=(B, 14, 14)).astype(np.float32)
        y = rng.integers(0, 10, size=B).astype(np.int32)
    else:
        jm = jsmall.CharLSTM(d_hidden=16, n_layers=1)
        tm = tsmall.CharLSTM(d_hidden=16, n_layers=1)
        x = rng.integers(0, 64, size=(B, 10)).astype(np.int32)
        y = rng.integers(0, 64, size=(B, 10)).astype(np.int32)
        y[0, 7:] = -100                              # IGNORE positions
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    if name == "logreg":          # zero init would make the test trivial
        jp = {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in jp.items()}
    w = np.array([1.0, 0.5, 2.0, 0.0, 1.0, 3.0], np.float32)
    batch = {"x": x, "y": y, "weights": w}
    return jm, tm, jp, batch


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["logreg", "cnn", "charlm"])
def test_model_matches_reference(name):
    jm, tm, jp, batch = _case(name)
    tp = params_from_jax(name, jp, device="cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    # one compiled program for the reference's forward quantities
    data = {k: v for k, v in batch.items() if k != "weights"}
    j_logits, (jl, jmet), j_acc, j_feats = jax.jit(lambda p, b, d: (
        jm.logits(p, b["x"]), jm.loss(p, b), jm.accuracy(p, b),
        jm.grad_features(p, d)))(jp, jb, {k: jnp.asarray(v)
                                          for k, v in data.items()})
    np.testing.assert_allclose(tm.logits(tp, _t(batch)["x"]).detach().numpy(),
                               np.asarray(j_logits), atol=ATOL)
    tl, tmet = tm.loss(tp, _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    np.testing.assert_allclose(tmet["per_example_loss"].detach().numpy(),
                               np.asarray(jmet["per_example_loss"]),
                               atol=ATOL)
    np.testing.assert_allclose(float(tm.accuracy(tp, _t(batch))),
                               float(j_acc), atol=ATOL)
    feats = grad_features(tm, tp, data).numpy()
    if name == "logreg":              # input-space features (§4.3)
        np.testing.assert_array_equal(feats, batch["x"])
    else:
        np.testing.assert_allclose(feats, np.asarray(j_feats), atol=ATOL)

    # one SGD step with the FedProx term against a shifted reference
    ref_j = jax.tree.map(lambda a: a + 0.05, jp)
    j_step = j_make_step(jm.loss, j_sgd(0.1), prox_mu=0.2, donate=False)
    jp1, _, jmet1 = j_step(jp, j_sgd(0.1).init(jp), jb, ref_j)
    t_step = make_train_step(tm.loss, sgd(0.1), prox_mu=0.2)
    tp1, _, tmet1 = t_step(tp, sgd(0.1).init(tp), _t(batch),
                           params_from_jax(name, ref_j, device="cpu"))
    want = params_from_jax(name, jax.tree.map(np.asarray, jp1), device="cpu")
    assert set(tp1) == set(want)
    for k in want:
        np.testing.assert_allclose(tp1[k].numpy(), want[k].numpy(),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(float(tmet1["total_loss"]),
                               float(jmet1["total_loss"]), atol=ATOL)


@pytest.mark.parametrize("name", ["cnn", "charlm"])
def test_param_names_and_convert_round_trip(name):
    jm, tm, jp, _ = _case(name)
    tp = params_from_jax(name, jp, device="cpu")
    assert set(tp) == {k for k, _ in tm.named_parameters()}
    for k, v in tm.named_parameters():
        assert tuple(tp[k].shape) == tuple(v.shape), k
    back = params_to_jax(name, tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    init = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}


def test_sgd_update_and_weighted_mean_are_bitwise():
    rng = np.random.default_rng(0)
    trees = [{"w": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=3).astype(np.float32)} for _ in range(4)]
    ws = [3.0, 1.0, 2.0, 5.0]
    want = j_twm([jax.tree.map(jnp.asarray, t) for t in trees], ws)
    got = tree_weighted_mean([{k: torch.as_tensor(v) for k, v in t.items()}
                              for t in trees], ws)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    g = {k: torch.as_tensor(v) for k, v in trees[1].items()}
    p = {k: torch.as_tensor(v) for k, v in trees[0].items()}
    upd, _ = sgd(0.03).update(g, sgd(0.03).init(p), p)
    jupd, _ = j_sgd(0.03).update(jax.tree.map(jnp.asarray, trees[1]),
                                 j_sgd(0.03).init(trees[0]), None)
    for k in p:
        np.testing.assert_array_equal((p[k] + upd[k]).numpy(),
                                      np.asarray(trees[0][k] + jupd[k]))
