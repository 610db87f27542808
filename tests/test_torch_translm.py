"""The slice as a whole: the ``translm`` fleet workload against the JAX one.

``CharTransformer`` (one pre-norm decoder block, vocab 64, d_model 32,
two heads of 16, SwiGLU d_ff 64, S = 16) runs on weights carried over
from the JAX init by ``repro_torch.convert``: its logits, loss, gradient
features and one SGD step agree with the JAX model's at atol 1e-5, with
attention naive or through ``ops.flash_attention`` (its plain forward on
the CPU, in the ``autograd.Function`` whose backward the card runs too).
The JAX model trains through its naive attention only: ``jax.grad``
through the Pallas kernel fails, as the kernel defines no VJP.

A 2-round ``run_fleet`` at the reference conformance matrix's size
(6 clients, mean 24, std 8, E = 2, B = 8, 40 % stragglers) runs in both
of the port's engines and is held against the JAX
``run_fleet(engine="loop")``: exact ``RoundRecord`` timing and violation
fields, equal medoids per (round, client), parameters within the
reference's ``PARAMS_ATOL`` for translm (1e-5).  ``use_kernel=None``
picks the naive attention on the CPU in both packages; one more cell
routes the port's attention through the op (the path the card runs
under ``vmap(grad)``), against the same JAX run.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.func import grad  # noqa: E402

import repro.fed.fleet.batched as jb  # noqa: E402
from repro.data.partition import train_test_split_clients  # noqa: E402
from repro.fed.fleet import workloads as jw  # noqa: E402
from repro.fed.simulator import make_client_specs  # noqa: E402
import repro_torch.fed.fleet.batched as tb  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.fed.fleet import (FleetConfig, get_workload,  # noqa: E402
                                   run_fleet)
from repro_torch.fed.fleet.workloads import CharTransformer  # noqa: E402
from repro_torch.fed.simulator import ClientSpec  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5               # PARAMS_ATOL of the conformance matrix for translm
N_CLIENTS, MEAN_M, STD_M = 6, 24.0, 8.0
CFG = dict(epochs=2, batch_size=8, lr=0.05, seed=0)
STRAGGLER_PCT = 40.0
ROUNDS = 2

_cache = {}


def _bundle():
    """Client data (the reference's bytes), specs and JAX init weights."""
    if "bundle" not in _cache:
        jwl = jw.get_workload("translm")
        clients = jwl.make_clients(n_clients=N_CLIENTS, seed=0,
                                   mean_samples=MEAN_M, std_samples=STD_M)
        train, test = train_test_split_clients(clients, test_frac=0.1)
        specs = make_client_specs([len(d["y"]) for d in train],
                                  np.random.default_rng(0))
        jp = jax.tree.map(np.asarray, jwl.init(jax.random.PRNGKey(0)))
        _cache["bundle"] = (jwl, train, test, specs, jp)
    return _cache["bundle"]


def _through_op(model):
    """Route ``model``'s attention through ``ops.flash_attention`` on the
    CPU, where ``use_kernel=None`` would pick the naive attention."""
    model.impl = lambda tokens: "kernel"
    return model


def _batch():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 64, size=(6, 16)).astype(np.int32)
    y = rng.integers(0, 64, size=(6, 16)).astype(np.int32)
    y[1, 11:] = -100                             # IGNORE positions
    w = np.array([1.0, 0.5, 2.0, 0.0, 1.0, 3.0], np.float32)
    return {"x": x, "y": y, "weights": w}


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_char_transformer_matches_reference(impl):
    _, _, _, _, jp = _bundle()
    jm = jw.CharTransformer(vocab=64, use_kernel=False)
    tm = CharTransformer(vocab=64)
    assert tm.impl(torch.zeros(1)) == "naive"       # None on the CPU
    if impl == "kernel":
        _through_op(tm)
    tp = params_from_jax("translm", jp, device="cpu")
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    # the JAX side jitted: eager JAX compiles each op on its own
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
    jg = jg[1]
    tg = grad(lambda p: tm.loss(p, tbatch)[0])(tp)
    want = params_from_jax("translm", jax.tree.map(
        lambda p, g: np.asarray(p - 0.05 * g), jp, jg), device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose((tp[k] - 0.05 * tg[k]).numpy(), v.numpy(),
                                   atol=ATOL, err_msg=k)


def test_kernel_switch_on_the_cpu():
    tokens = torch.zeros((2, 16), dtype=torch.int32)
    assert CharTransformer(use_kernel=False).impl(tokens) == "naive"
    with pytest.raises(ValueError, match="CUDA"):
        CharTransformer(use_kernel=True).impl(tokens)


def test_convert_round_trip_keeps_every_leaf():
    """JAX's dense kernels are (d_in, d_out) and the port multiplies
    ``x @ W``: every translm leaf carries over unchanged, under its tree
    path."""
    _, _, _, _, jp = _bundle()
    tp = params_from_jax("translm", jp, device="cpu")
    assert set(tp) == {"embed", "norm_attn.scale", "attn.wq", "attn.wk",
                       "attn.wv", "attn.wo", "norm_mlp.scale", "mlp.w_gate",
                       "mlp.w_up", "mlp.w_down", "norm_out.scale", "w_out",
                       "b_out"}
    own = CharTransformer(vocab=64).init(torch.Generator().manual_seed(0),
                                         "cpu")
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in tp.items()}
    flat = {f"{a}.{b}" if isinstance(v, dict) else a: (v[b] if b else v)
            for a, v in jp.items()
            for b in (v if isinstance(v, dict) else [None])}
    for k, v in flat.items():
        np.testing.assert_array_equal(tp[k].numpy(), v, err_msg=k)
    back = params_to_jax("translm", tp)
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


@pytest.mark.parametrize("engine,impl", [("batched", "naive"),
                                         ("loop", "naive"),
                                         ("batched", "kernel")])
def test_run_fleet_matches_reference(engine, impl, monkeypatch):
    jout, j_medoids = _reference(monkeypatch)
    _, train, test, specs, jp = _bundle()
    wl = get_workload("translm")
    if impl == "kernel":
        _through_op(wl.model)
    medoids = _recording(monkeypatch, tb)
    out = run_fleet(
        wl, train, [ClientSpec(s.cid, s.m, s.c) for s in specs],
        FleetConfig(**CFG), ROUNDS, straggler_pct=STRAGGLER_PCT,
        test_data=test, init_params=params_from_jax("translm", jp,
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
    assert any(len(r) for r in medoids)
    for got, want in zip(medoids, j_medoids):
        assert set(got) == set(want)
        for cid in want:
            np.testing.assert_array_equal(got[cid], want[cid],
                                          err_msg=f"client {cid}")
    want = params_from_jax("translm",
                           jax.tree.map(np.asarray, jout["params"]),
                           device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                   atol=ATOL, err_msg=k)
