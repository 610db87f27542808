"""The ``xlstm`` fleet workload against the JAX one.

The mLSTM block (``repro_torch.models.xlstm``) runs on weights carried
over from the JAX init by ``repro_torch.convert``: its forward and its
decode continuation at the shapes of ``tests/test_models.py``'s xLSTM
test agree with the JAX block at 1e-5.  ``CharXLSTM`` (vocab 64,
d_model 32, two heads of 16, S = 16; its norm through
``ops.rmsnorm``'s plain version here) agrees in logits, loss, gradient
features and one SGD step at 1e-5.

A 2-round ``run_fleet`` at the reference conformance matrix's size
(6 clients, mean 24, std 8, E = 2, B = 8, 40 % stragglers) runs in both
of the port's engines and is held against the JAX
``run_fleet(engine="loop")``: exact ``RoundRecord`` timing and violation
fields, equal medoids per (round, client), parameters within the
reference's ``PARAMS_ATOL`` for xlstm (1e-5).  The reference's own
kernel-on/off cell for xlstm fails: two float32 selections of the JAX
package pick different, equally good medoids.  With the capabilities of
seed 0, client 1 (k = 16 of 29) meets such a tie: the port keeps sample
11 and XLA sample 23, and the two sets' float64 k-medoids objectives are
equal (0.4155869852495467 on the port's features); one round of
training on the other sample moves the parameters by 3e-4.  The fleet
here draws its capabilities from seed 1, which gives budgets k = 1 and
16 with no tied choice.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.func import grad  # noqa: E402

import repro.fed.fleet.batched as jb  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.data.partition import train_test_split_clients  # noqa: E402
from repro.fed.fleet import workloads as jw  # noqa: E402
from repro.fed.simulator import make_client_specs  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
import repro_torch.fed.fleet.batched as tb  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.fed.fleet import (FleetConfig, get_workload,  # noqa: E402
                                   run_fleet)
from repro_torch.fed.fleet.workloads import CharXLSTM  # noqa: E402
from repro_torch.fed.simulator import ClientSpec  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5               # PARAMS_ATOL of the conformance matrix for xlstm
N_CLIENTS, MEAN_M, STD_M = 6, 24.0, 8.0
CFG = dict(epochs=2, batch_size=8, lr=0.05, seed=0)
STRAGGLER_PCT = 40.0
ROUNDS = 2
SPEC_SEED = 1             # capabilities (see the module docstring)

_cache = {}


def _bundle():
    """Client data (the reference's bytes), specs and JAX init weights."""
    if "bundle" not in _cache:
        jwl = jw.get_workload("xlstm")
        clients = jwl.make_clients(n_clients=N_CLIENTS, seed=0,
                                   mean_samples=MEAN_M, std_samples=STD_M)
        train, test = train_test_split_clients(clients, test_frac=0.1)
        specs = make_client_specs([len(d["y"]) for d in train],
                                  np.random.default_rng(SPEC_SEED))
        jp = jax.tree.map(np.asarray, jwl.init(jax.random.PRNGKey(0)))
        _cache["bundle"] = (jwl, train, test, specs, jp)
    return _cache["bundle"]


def _block_params(jp):
    """The JAX block's nested params as the port's nested dict."""
    return {k: ({"scale": torch.tensor(np.asarray(v["scale"]))}
                if k == "norm" else torch.tensor(np.asarray(v)))
            for k, v in jp.items()}


def test_mlstm_block_and_decode_match_reference():
    """The JAX test's shapes: d_model 64, four heads, x (2, 10, 64);
    the full forward, and a 6-step prefill continued by four decode
    steps."""
    jcfg = JModelConfig(d_model=64, n_heads=4, n_kv_heads=4, d_ff=0)
    cfg = ModelConfig(d_model=64, n_heads=4, n_kv_heads=4)
    assert cfg.norm_eps == jcfg.norm_eps
    jp = jx.init_mlstm(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(1).standard_normal((2, 10, 64)).astype(
        np.float32)
    tp = _block_params(jp)
    jy, jst = jx.mlstm_block(jp, jcfg, jnp.asarray(x))
    ty, tst = tx.mlstm_block(tp, cfg, torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)

    jys, tys = [], []
    jy_pre, jst = jx.mlstm_block(jp, jcfg, jnp.asarray(x[:, :6]))
    ty_pre, tst = tx.mlstm_block(tp, cfg, torch.tensor(x[:, :6]))
    jys.append(np.asarray(jy_pre))
    tys.append(ty_pre.numpy())
    for t in range(6, 10):
        jy_t, jst = jx.mlstm_block(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jst,
                                   decode=True)
        ty_t, tst = tx.mlstm_block(tp, cfg, torch.tensor(x[:, t:t + 1]),
                                   tst, decode=True)
        jys.append(np.asarray(jy_t))
        tys.append(ty_t.numpy())
    got = np.concatenate(tys, 1)
    np.testing.assert_allclose(got, np.concatenate(jys, 1), rtol=1e-5,
                               atol=1e-5)
    # and the port's decode continues its own forward
    np.testing.assert_allclose(got, ty.numpy(), rtol=1e-5, atol=1e-5)


def _batch():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 64, size=(6, 16)).astype(np.int32)
    y = rng.integers(0, 64, size=(6, 16)).astype(np.int32)
    y[1, 11:] = -100                             # IGNORE positions
    w = np.array([1.0, 0.5, 2.0, 0.0, 1.0, 3.0], np.float32)
    return {"x": x, "y": y, "weights": w}


def test_char_xlstm_matches_reference():
    _, _, _, _, jp = _bundle()
    jm = jw.CharXLSTM(vocab=64)
    tm = CharXLSTM(vocab=64)
    tp = params_from_jax("xlstm", jp, device="cpu")
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    jlogits, jfeats, jacc, jg = jax.jit(lambda p, b: (
        jm.logits(p, b["x"]), jm.grad_features(p, b), jm.accuracy(p, b),
        jax.value_and_grad(lambda q: jm.loss(q, b)[0])(p)))(jp, jbatch)
    np.testing.assert_allclose(tm.logits(tp, tbatch["x"]).numpy(),
                               np.asarray(jlogits), atol=ATOL)
    np.testing.assert_allclose(tm.loss(tp, tbatch)[0].item(), float(jg[0]),
                               atol=ATOL)
    np.testing.assert_allclose(tm.grad_features(tp, tbatch).numpy(),
                               np.asarray(jfeats), atol=ATOL)
    np.testing.assert_allclose(tm.accuracy(tp, tbatch).item(), float(jacc),
                               atol=ATOL)
    # one SGD step, lr 0.05
    tg = grad(lambda p: tm.loss(p, tbatch)[0])(tp)
    want = params_from_jax("xlstm", jax.tree.map(
        lambda p, g: np.asarray(p - 0.05 * g), jp, jg[1]), device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose((tp[k] - 0.05 * tg[k]).numpy(), v.numpy(),
                                   atol=ATOL, err_msg=k)


def test_kernel_switch_on_the_cpu():
    tm = CharXLSTM(vocab=64)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, 16), dtype=torch.int32)
    assert torch.equal(CharXLSTM(use_kernel=False).logits(params, tokens),
                       tm.logits(params, tokens))
    with pytest.raises(ValueError, match="CUDA"):
        CharXLSTM(use_kernel=True).logits(params, tokens)


def test_convert_round_trip_keeps_every_leaf():
    """Every xlstm leaf carries over unchanged, under its tree path."""
    _, _, _, _, jp = _bundle()
    tp = params_from_jax("xlstm", jp, device="cpu")
    assert set(tp) == {"embed", "mlstm.norm.scale", "mlstm.wq", "mlstm.wk",
                       "mlstm.wv", "mlstm.wi", "mlstm.wf", "mlstm.bf",
                       "mlstm.bi", "mlstm.wo_gate", "mlstm.w_out", "w_out",
                       "b_out"}
    own = CharXLSTM(vocab=64).init(torch.Generator().manual_seed(0), "cpu")
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in tp.items()}
    np.testing.assert_array_equal(tp["mlstm.norm.scale"].numpy(),
                                  jp["mlstm"]["norm"]["scale"])
    np.testing.assert_array_equal(tp["mlstm.bf"].numpy(), jp["mlstm"]["bf"])
    back = params_to_jax("xlstm", tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def _recording(monkeypatch, module):
    """Record each round's medoids {cid: indices} of ``module``'s
    ``run_fleet``."""
    rounds = []
    inner = module.run_fleet_round

    def run_fleet_round(*args, **kwargs):
        params, stats = inner(*args, **kwargs)
        rounds.append({c: np.asarray(m) for c, m in stats.medoids.items()})
        return params, stats

    monkeypatch.setattr(module, "run_fleet_round", run_fleet_round)
    return rounds


def _reference(monkeypatch):
    if "ref" not in _cache:
        jwl, train, test, specs, jp = _bundle()
        with monkeypatch.context() as mp:
            medoids = _recording(mp, jb)
            out = jb.run_fleet(jwl, train, specs, jb.FleetConfig(**CFG),
                               ROUNDS, straggler_pct=STRAGGLER_PCT,
                               test_data=test, init_params=jp, engine="loop")
        _cache["ref"] = (out, medoids)
    return _cache["ref"]


@pytest.mark.parametrize("engine", ["batched", "loop"])
def test_run_fleet_matches_reference(engine, monkeypatch):
    jout, j_medoids = _reference(monkeypatch)
    _, train, test, specs, jp = _bundle()
    medoids = _recording(monkeypatch, tb)
    out = run_fleet(
        get_workload("xlstm"), train,
        [ClientSpec(s.cid, s.m, s.c) for s in specs],
        FleetConfig(**CFG), ROUNDS, straggler_pct=STRAGGLER_PCT,
        test_data=test, init_params=params_from_jax("xlstm", jp,
                                                    device="cpu"),
        engine=engine, device="cpu")

    # the straggler (coreset) path and the full-set path both ran
    assert all(0 < h.n_coreset < h.n_participants for h in out["history"])
    assert out["deadline"] == jout["deadline"]
    for a, b in zip(out["history"], jout["history"]):
        assert a.sim_round_time == b.sim_round_time
        assert a.client_times == b.client_times
        assert (a.n_participants, a.n_dropped, a.n_coreset,
                a.n_violations) == (b.n_participants, b.n_dropped,
                                    b.n_coreset, b.n_violations)
        np.testing.assert_allclose(a.train_loss, b.train_loss, atol=ATOL)
        np.testing.assert_allclose(a.test_acc, b.test_acc, atol=ATOL)
    assert len(medoids) == len(j_medoids) == ROUNDS
    assert {len(m) for r in medoids for m in r.values()} == {1, 16}
    for got, want in zip(medoids, j_medoids):
        assert set(got) == set(want)
        for cid in want:
            np.testing.assert_array_equal(got[cid], want[cid],
                                          err_msg=f"client {cid}")
    want = params_from_jax("xlstm",
                           jax.tree.map(np.asarray, jout["params"]),
                           device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                   atol=ATOL, err_msg=k)
