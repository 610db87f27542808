"""The port's optimisers, schedules, tree helpers and train step against
the JAX package's: the same gradients through ``sgd`` with momentum and
Nesterov, ``adam`` and ``adamw`` for 10 steps within 1e-6, every
schedule at steps 0-50 within 1e-7, ``clip_by_global_norm``, and
``make_train_step`` with ``clip_norm`` and ``accum_steps`` on a dense
``Model`` within 1e-5."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.optim as jopt  # noqa: E402
import repro.utils.tree as jtree  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
import repro_torch.utils.tree as ttree  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.training import (  # noqa: E402
    make_eval_step as j_eval_step, make_grad_fn as j_grad_fn,
    make_train_step as j_train_step)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.training import (  # noqa: E402
    make_eval_step, make_grad_fn, make_train_step)

OPT_ATOL = 1e-6
SCHED_ATOL = 1e-7
STEP_ATOL = 1e-5


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((5, 3)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(7) * scale).astype(np.float32)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.tensor(np.asarray(v))
    return out


def _close(t_flat, j_tree, atol):
    want = _flat(jax.tree.map(np.asarray, j_tree))
    assert sorted(t_flat) == sorted(want)
    for k in want:
        np.testing.assert_allclose(t_flat[k].numpy(), want[k].numpy(),
                                   atol=atol, rtol=0, err_msg=k)


def _schedule():
    return (jopt.warmup_cosine_lr(0.05, 3, 10),
            topt.warmup_cosine_lr(0.05, 3, 10))


@pytest.mark.parametrize("name", ["sgd", "sgd_sched", "momentum", "nesterov",
                                  "adam", "adam_sched", "adamw"])
def test_optimizer_matches_reference(name):
    js, ts = _schedule()
    make = {"sgd": lambda m, lr: m.sgd(lr),
            "sgd_sched": lambda m, lr: m.sgd(js if m is jopt else ts),
            "momentum": lambda m, lr: m.sgd(lr, momentum=0.9),
            "nesterov": lambda m, lr: m.sgd(lr, momentum=0.9,
                                            nesterov=True),
            "adam": lambda m, lr: m.adam(lr),
            "adam_sched": lambda m, lr: m.adam(js if m is jopt else ts),
            "adamw": lambda m, lr: m.adamw(lr, weight_decay=0.1)}[name]
    jo, to = make(jopt, 0.05), make(topt, 0.05)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = _flat(_tree(0))
    js_, ts_ = jo.init(jp), to.init(tp)
    for i in range(10):
        g = _tree(100 + i)
        ju, js_ = jo.update(jax.tree.map(jnp.asarray, g), js_, jp)
        tu, ts_ = to.update(_flat(g), ts_, tp)
        jp = jtree.tree_add(jp, ju)
        tp = ttree.tree_add(tp, tu)
        _close(tu, ju, OPT_ATOL)
        _close(tp, jp, OPT_ATOL)
    assert int(ts_["step"]) == int(js_["step"]) == 10
    assert ts_["step"].dtype == torch.int32


@pytest.mark.parametrize("name", ["constant", "inverse_time", "cosine",
                                  "warmup_cosine", "warmup_cosine_long"])
def test_schedule_matches_reference(name):
    args = {"constant": ("constant_lr", (0.3,)),
            "inverse_time": ("inverse_time_lr", (2.0, 10.0)),
            "cosine": ("cosine_lr", (1.0, 40)),
            "warmup_cosine": ("warmup_cosine_lr", (3e-4, 2, 40)),
            "warmup_cosine_long": ("warmup_cosine_lr", (1.0, 10, 110,
                                                        0.2))}[name]
    jf = getattr(jopt, args[0])(*args[1])
    tf = getattr(topt, args[0])(*args[1])
    for step in range(51):
        want = jf(jnp.asarray(step, jnp.int32))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=SCHED_ATOL, err_msg=str(step))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(3, scale=4.0)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = topt.clip_by_global_norm(_flat(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close(tc, jc, OPT_ATOL)
    if max_norm > float(jn):
        assert all(torch.equal(tc[k], v) for k, v in _flat(g).items())


def test_tree_helpers_match_reference():
    a, b = _tree(0), _tree(1)
    ja = jax.tree.map(jnp.asarray, a)
    ta, tb = _flat(a), _flat(b)
    np.testing.assert_allclose(float(ttree.global_norm(ta)),
                               float(jtree.global_norm(ja)), rtol=1e-6)
    assert ttree.param_count(ta) == jtree.param_count(ja) == 22
    assert ttree.tree_allclose(ta, {k: v.clone() for k, v in ta.items()})
    assert not ttree.tree_allclose(ta, tb)
    assert not ttree.tree_allclose(ta, {"a": ta["a"]})
    z = ttree.tree_zeros_like(ta)
    assert all(torch.equal(z[k], torch.zeros_like(ta[k])) for k in ta)
    kids = ttree.split_keys(torch.Generator().manual_seed(0), 3)
    draws = [torch.randn(4, generator=g) for g in kids]
    assert len(kids) == 3 and not torch.equal(draws[0], draws[1])
    again = [torch.randn(4, generator=g) for g in
             ttree.split_keys(torch.Generator().manual_seed(0), 3)]
    assert all(torch.equal(x, y) for x, y in zip(draws, again))


def _dense_pair(window=None):
    kw = dict(arch_id="t", family="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
              attention_window=window)
    jm, tm = JModel(JConfig(**kw)), Model(ModelConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax("dense", jax.tree.map(np.asarray, jp),
                         device="cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 64, (8, 16)).astype(np.int32),
             "labels": rng.integers(0, 64, (8, 16)).astype(np.int32),
             "weights": rng.uniform(0.5, 2.0, 8).astype(np.float32)}
    batch["labels"][0, :5] = -100
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    return jm, tm, jp, tp, jb, tb


@pytest.mark.parametrize("case", ["clip", "accum", "clip_accum_momentum"])
def test_train_step_matches_reference(case):
    jm, tm, jp, tp, jb, tb = _dense_pair()
    kw = {"clip": dict(clip_norm=0.5),
          "accum": dict(accum_steps=2),
          "clip_accum_momentum": dict(clip_norm=1.0, accum_steps=2)}[case]
    make = (lambda m: m.sgd(0.5, momentum=0.9)) if "momentum" in case \
        else (lambda m: m.sgd(0.5))
    jo, to = make(jopt), make(topt)
    jstep = j_train_step(jm.loss, jo, donate=False, **kw)
    tstep = make_train_step(tm.loss, to, **kw)
    jst, tst = jo.init(jp), to.init(tp)
    for _ in range(2):
        jp, jst, jmet = jstep(jp, jst, jb)
        tp, tst, tmet = tstep(tp, tst, tb)
        _close(tp, jp, STEP_ATOL)
        for key in ("loss", "total_loss", "per_example_loss") + (
                ("grad_norm",) if "clip" in case else ()):
            np.testing.assert_allclose(tmet[key].numpy(),
                                       np.asarray(jmet[key]), rtol=1e-5,
                                       atol=STEP_ATOL, err_msg=key)
    if "clip" not in case:
        assert "grad_norm" not in tmet


def test_eval_step_and_grad_fn_match_reference():
    jm, tm, jp, tp, jb, tb = _dense_pair(window=5)
    jmet = j_eval_step(jm.loss)(jp, jb)
    tmet = make_eval_step(tm.loss)(tp, tb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    jg, _ = j_grad_fn(jm.loss)(jp, jb)
    tg, tmet2 = make_grad_fn(tm.loss)(tp, tb)
    _close(tg, jg, STEP_ATOL)
    np.testing.assert_allclose(float(tmet2["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
