"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on converted weights: ``moe_ffn`` at
capacity factors 0.5, 1.25 and 4.0 and 4 or 16 experts (output and aux
within 1e-5, the same tokens dropped), the dense oracle, the sort-based
dispatch against the port's own oracle at a generous capacity, the
gradients of every leaf against ``jax.grad``, and the dispatch
invariants of ``tests/test_moe_properties.py``.

XLA's and torch's router products round differently (about 1e-7), so a
near-tie between two experts could flip the choice: each input's
smallest gap between the top two router probabilities is checked to be
above ``TIE_GAP`` before anything is compared."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ATOL = 1e-5
TIE_GAP = 1e-5


def _cfgs(e, cf, shared=True, d=32, f=64):
    kw = dict(arch_id="t", family="moe", d_model=d, n_heads=4,
              n_kv_heads=4, d_ff=f, n_experts=e, moe_capacity_factor=cf,
              use_shared_expert=shared)
    return JConfig(**kw), ModelConfig(**kw)


def _setup(e, cf, shared=True, b=2, s=24, seed=0, scale=1.0):
    jcfg, tcfg = _cfgs(e, cf, shared)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax("moe", jax.tree.map(np.asarray, jp), device="cpu")
    x = (np.random.default_rng(seed + 1).standard_normal(
        (b, s, jcfg.d_model)) * scale).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _min_gap(jp, x):
    """The smallest gap between a token's top two router probabilities
    (the JAX package's arithmetic)."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = np.asarray(jax.nn.softmax(xt @ jp["router"], axis=-1))
    top = np.sort(probs, axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


def _dropped(y):
    """The tokens whose routed output is exactly zero."""
    rows = np.asarray(y).reshape(-1, y.shape[-1])
    return set(np.flatnonzero(~rows.any(axis=-1)).tolist())


@pytest.mark.parametrize("e", [4, 16])
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_moe_ffn_matches_reference(e, cf):
    jcfg, tcfg, jp, tp, x = _setup(e, cf, s=40)
    assert _min_gap(jp, x) > TIE_GAP
    jy, jaux = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    ty, taux = moe.moe_ffn(tp, tcfg, torch.tensor(x))
    assert ty.shape == (2, 40, 32) and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL,
                               rtol=ATOL)
    # the same tokens dropped: without the shared expert a dropped
    # token's output is exactly zero in both packages
    jcfg0, tcfg0 = _cfgs(e, cf, shared=False)
    jr, _ = jmoe.moe_ffn(jp, jcfg0, jnp.asarray(x))
    tr, _ = moe.moe_ffn(tp, tcfg0, torch.tensor(x))
    dropped = _dropped(tr.numpy())
    assert dropped == _dropped(np.asarray(jr))
    n = x.shape[0] * x.shape[1]
    cap = moe._capacity(n, e, cf)
    assert cap == jmoe._capacity(n, e, cf)
    expert = np.asarray(jnp.argmax(jnp.asarray(x.reshape(n, -1))
                                   @ jp["router"], axis=-1))
    over = sum(max(0, c - cap) for c in np.bincount(expert, minlength=e))
    assert len(dropped) == over
    if cf == 0.5:
        assert dropped


@pytest.mark.parametrize("e", [4, 16])
def test_dispatch_keeps_the_first_cap_tokens_of_each_expert(e):
    """``dispatch`` keeps, for each expert, its first ``cap`` tokens in
    token order (the stable sort), each in its own slot, and sends the
    rest to the scratch row."""
    rng = np.random.default_rng(e)
    expert = torch.tensor(rng.integers(0, e, 200))
    cap = 9
    order, slot, keep = moe.dispatch(expert, e, cap)
    assert torch.equal(expert[order], torch.sort(expert, stable=True)[0])
    seen = {}
    for i, j in enumerate(order.tolist()):
        r = seen.setdefault(int(expert[j]), 0)
        seen[int(expert[j])] += 1
        assert bool(keep[i]) == (r < cap)
        assert int(slot[i]) == (int(expert[j]) * cap + r if r < cap
                                else e * cap)
    kept = slot[keep]
    assert len(set(kept.tolist())) == len(kept)


@pytest.mark.parametrize("e,shared", [(4, True), (16, False)])
def test_dense_oracle_matches_reference(e, shared):
    # seed 4: at seed 3 two experts of E = 16 tie within 2.5e-6
    jcfg, tcfg, jp, tp, x = _setup(e, 1.25, shared=shared, seed=4)
    assert _min_gap(jp, x) > TIE_GAP
    jy, jaux = jmoe.moe_ffn_dense_oracle(jp, jcfg, jnp.asarray(x))
    ty, taux = moe.moe_ffn_dense_oracle(tp, tcfg, torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("e", [4, 16])
def test_generous_capacity_equals_own_oracle(e):
    """At a capacity of every token no token drops, and the sort-based
    dispatch is the dense oracle (the reference's
    ``test_moe_matches_dense_oracle``)."""
    _, tcfg, _, tp, x = _setup(e, float(e), seed=5)
    a, aux_a = moe.moe_ffn(tp, tcfg, torch.tensor(x))
    b, aux_b = moe.moe_ffn_dense_oracle(tp, tcfg, torch.tensor(x))
    torch.testing.assert_close(a, b, atol=ATOL, rtol=ATOL)
    torch.testing.assert_close(aux_a, aux_b, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("e,cf", [(4, 1.25), (4, 0.5), (16, 1.25)])
def test_grads_match_jax_grad(e, cf):
    """d/dθ of sum(y·r) + 0.01·aux for every leaf (router, experts,
    shared expert) against ``jax.grad``: the router's through the gate
    and the aux loss, dropped tokens' rows of the experts through
    nothing."""
    jcfg, tcfg, jp, tp, x = _setup(e, cf, s=20, seed=7)
    assert _min_gap(jp, x) > TIE_GAP
    r = np.random.default_rng(11).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p):
        y, aux = jmoe.moe_ffn(p, jcfg, jnp.asarray(x))
        return jnp.sum(y * r) + 0.01 * aux

    want = params_from_jax("moe", jax.tree.map(np.asarray,
                                               jax.grad(jloss)(jp)),
                           device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, aux = moe.moe_ffn(leaves, tcfg, torch.tensor(x))
    (y * torch.tensor(r)).sum().add(0.01 * aux).backward()
    assert sorted(want) == sorted(leaves)
    for k in want:
        got = leaves[k].grad
        assert got is not None and bool(torch.isfinite(got).all()), k
        scale = max(1.0, float(want[k].abs().max()))
        np.testing.assert_allclose(got.numpy(), want[k].numpy(),
                                   atol=ATOL * scale, rtol=0, err_msg=k)
    assert float(leaves["router"].grad.norm()) > 0


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("e", [2, 4, 8])
def test_dispatch_conserves_or_drops(seed, e):
    """Every routed output row is either its expert's output scaled by
    its gate or exactly zero (capacity-dropped)."""
    _, tcfg, _, tp, x = _setup(e, 0.75, shared=False, b=1, s=4 + 5 * seed,
                               seed=seed)
    y, aux = moe.moe_ffn(tp, tcfg, torch.tensor(x))
    yo, _ = moe.moe_ffn_dense_oracle(tp, tcfg, torch.tensor(x))
    for t in range(x.shape[1]):
        dropped = not bool(y[0, t].any())
        matches = torch.allclose(y[0, t], yo[0, t], rtol=1e-4, atol=1e-5)
        assert dropped or matches, f"token {t} neither dropped nor routed"
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("seed", range(3))
def test_aux_loss_bounds(seed):
    _, tcfg, _, tp, x = _setup(8, 1.25, b=1, s=32, seed=seed, scale=3.0)
    _, aux = moe.moe_ffn(tp, tcfg, torch.tensor(x))
    assert 0.0 <= float(aux) <= tcfg.n_experts


def test_capacity_drops_dont_nan_and_tree_round_trips():
    jcfg, tcfg, jp, tp, x = _setup(4, 0.5, s=32)
    y, aux = moe.moe_ffn(tp, tcfg, torch.tensor(x))
    assert bool(torch.isfinite(y).all()) and float(aux) > 0
    back = params_to_jax("moe", tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    own = moe.init_moe(torch.Generator().manual_seed(0), tcfg)
    assert sorted(own) == sorted(tp)
    assert all(own[k].shape == tp[k].shape for k in tp)
    assert moe._capacity(4, 16, 1.25) == 8          # decode at batch 4
    assert moe._capacity(4096, 16, 1.25) == 320     # scout's prefill
