"""The port's Mamba2 (SSD) block (``repro_torch.models.mamba2``) against
the JAX package's ``repro.models.mamba2`` on the same inputs and
converted weights, at the reference's own tolerance (1e-4,
``tests/test_models.py``): ``ssd_chunked`` and ``ssd_sequential`` at
chunks 4, 8 and 16, a ragged S and a continued state, ``_segsum``,
``causal_conv`` and ``causal_conv_step``, and ``mamba2_block`` in
prefill and in decode continuation (8 tokens prefilled, then token by
token), with its gradients against ``jax.grad``."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

TOL = 1e-4
CFG = dict(d_model=32, n_heads=4, n_kv_heads=4, d_ff=64, ssm_state=8,
           ssm_headdim=16, ssm_chunk=8)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _ssd_inputs(b, s, nh, hd, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    a = -np.logaddexp(rng.standard_normal((b, s, nh)), 0).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, a, B, C


@pytest.mark.parametrize("s", [23, 32])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_and_sequential_match_reference(chunk, s):
    args = _ssd_inputs(2, s, 4, 16, 8)
    jy, jh = jm2.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty, th = mamba2.ssd_chunked(*map(torch.tensor, args), chunk=chunk)
    assert ty.shape == (2, s, 4, 16) and th.shape == (2, 4, 16, 8)
    _close(ty, jy)
    _close(th, jh)
    sy, sh = mamba2.ssd_sequential(*map(torch.tensor, args))
    jsy, jsh = jm2.ssd_sequential(*map(jnp.asarray, args))
    _close(sy, jsy)
    _close(sh, jsh)
    _close(ty, sy.numpy())
    _close(th, sh.numpy())


@pytest.mark.parametrize("chunk", [4, 16])
def test_ssd_from_a_prior_state_matches_reference(chunk):
    args = _ssd_inputs(2, 13, 4, 16, 8, seed=1)
    h0 = np.random.default_rng(2).standard_normal((2, 4, 16, 8)).astype(
        np.float32)
    jy, jh = jm2.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                             h0=jnp.asarray(h0))
    ty, th = mamba2.ssd_chunked(*map(torch.tensor, args), chunk=chunk,
                                h0=torch.tensor(h0))
    _close(ty, jy)
    _close(th, jh)
    sy, sh = mamba2.ssd_sequential(*map(torch.tensor, args),
                                   h0=torch.tensor(h0))
    _close(sy, np.asarray(jy))
    _close(sh, np.asarray(jh))


def test_segsum_masks_before_the_exp():
    a = np.random.default_rng(3).standard_normal((2, 3, 6)).astype(
        np.float32)
    got = mamba2._segsum(torch.tensor(a))
    want = np.asarray(jm2._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-6,
                               atol=1e-6)
    # the upper triangle's exp is 0 and carries no NaN back
    t = torch.tensor(a, requires_grad=True)
    torch.exp(mamba2._segsum(t)).sum().backward()
    assert bool(torch.isfinite(t.grad).all())


@pytest.mark.parametrize("k,c", [(4, 24), (2, 7)])
def test_causal_conv_and_step_match_reference(k, c):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 9, c)).astype(np.float32)
    w = rng.standard_normal((k, c)).astype(np.float32)
    b = rng.standard_normal((c,)).astype(np.float32)
    want = jm2.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = mamba2.causal_conv(torch.tensor(x), torch.tensor(w),
                             torch.tensor(b))
    _close(got, want, 1e-5)
    state = rng.standard_normal((2, k - 1, c)).astype(np.float32)
    js, jy = jm2.causal_conv_step(jnp.asarray(state), jnp.asarray(x[:, :1]),
                                  jnp.asarray(w), jnp.asarray(b))
    ts, ty = mamba2.causal_conv_step(torch.tensor(state),
                                     torch.tensor(x[:, :1]),
                                     torch.tensor(w), torch.tensor(b))
    _close(ts, js, 0)
    _close(ty, jy, 1e-5)
    # stepping through x from a zero state is the causal conv
    st = torch.zeros((2, k - 1, c))
    ys = []
    for t in range(x.shape[1]):
        st, y = mamba2.causal_conv_step(st, torch.tensor(x[:, t:t + 1]),
                                        torch.tensor(w), torch.tensor(b))
        ys.append(y)
    _close(torch.cat(ys, 1), np.asarray(want), 1e-5)


def _block(seed=0, **kw):
    jcfg, tcfg = JConfig(**CFG, **kw), ModelConfig(**CFG, **kw)
    jp = jm2.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax("mamba2", jax.tree.map(np.asarray, jp),
                         device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("s", [12, 19])
def test_block_prefill_and_decode_continuation_match_reference(s):
    jcfg, tcfg, jp, tp = _block()
    u = np.random.default_rng(4).standard_normal((2, s, 32)).astype(
        np.float32)
    jy, jst = jm2.mamba2_block(jp, jcfg, jnp.asarray(u))
    ty, tst = mamba2.mamba2_block(tp, tcfg, torch.tensor(u))
    _close(ty, jy)
    _close(tst.ssm, jst.ssm)
    _close(tst.conv, jst.conv)
    # 8 tokens prefilled, then token by token, in both packages
    _, jst = jm2.mamba2_block(jp, jcfg, jnp.asarray(u[:, :8]))
    _, tst = mamba2.mamba2_block(tp, tcfg, torch.tensor(u[:, :8]))
    ys = []
    for t in range(8, s):
        jy_t, jst = jm2.mamba2_block(jp, jcfg, jnp.asarray(u[:, t:t + 1]),
                                     jst, decode=True)
        ty_t, tst = mamba2.mamba2_block(tp, tcfg, torch.tensor(u[:, t:t + 1]),
                                        tst, decode=True)
        _close(ty_t, jy_t)
        _close(tst.ssm, jst.ssm)
        _close(tst.conv, jst.conv)
        ys.append(ty_t)
    # and the continuation is the prefill's tail
    _close(torch.cat(ys, 1), ty[:, 8:].detach().numpy())
    with pytest.raises(ValueError, match="prior state"):
        mamba2.mamba2_block(tp, tcfg, torch.tensor(u), tst)


def test_decode_from_a_bf16_state_promotes_to_float32():
    """The JAX package's ``init_decode_state`` defaults to bf16; its
    decode multiplies and concatenates in float32, so the state comes
    back float32 from the first step on.  The port does the same."""
    jcfg, tcfg, jp, tp = _block(seed=1)
    u = np.random.default_rng(5).standard_normal((2, 3, 32)).astype(
        np.float32)
    jst = jm2.init_mamba_state(jcfg, 2, jnp.bfloat16)
    tst = mamba2.init_mamba_state(tcfg, 2, torch.bfloat16)
    assert tst.ssm.dtype == torch.bfloat16
    assert tuple(tst.ssm.shape) == jst.ssm.shape
    assert tuple(tst.conv.shape) == jst.conv.shape
    for t in range(3):
        jy, jst = jm2.mamba2_block(jp, jcfg, jnp.asarray(u[:, t:t + 1]), jst,
                                   decode=True)
        ty, tst = mamba2.mamba2_block(tp, tcfg, torch.tensor(u[:, t:t + 1]),
                                      tst, decode=True)
        assert str(tst.ssm.dtype).split(".")[-1] == str(jst.ssm.dtype)
        assert str(tst.conv.dtype).split(".")[-1] == str(jst.conv.dtype)
        _close(ty, jy)


def test_block_grads_match_jax_grad():
    jcfg, tcfg, jp, tp = _block(seed=2)
    u = np.random.default_rng(6).standard_normal((2, 11, 32)).astype(
        np.float32)
    r = np.random.default_rng(7).standard_normal((2, 11, 32)).astype(
        np.float32)

    def jloss(p):
        return jnp.sum(jm2.mamba2_block(p, jcfg, jnp.asarray(u))[0] * r)

    want = params_from_jax("mamba2", jax.tree.map(np.asarray,
                                                  jax.grad(jloss)(jp)),
                           device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, _ = mamba2.mamba2_block(leaves, tcfg, torch.tensor(u))
    (y * torch.tensor(r)).sum().backward()
    for k in want:
        g = leaves[k].grad
        assert g is not None and bool(torch.isfinite(g).all()), k
        scale = max(1.0, float(want[k].abs().max()))
        np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                   atol=TOL * scale, rtol=0, err_msg=k)


def test_param_tree_round_trips_and_init_shapes():
    """``conv_w`` keeps the reference's (K, C) layout: the conversion
    changes no leaf, both ways."""
    jcfg, tcfg, jp, tp = _block()
    assert tuple(tp["conv_w"].shape) == (tcfg.ssm_conv,
                                         tcfg.d_inner + 2 * tcfg.ssm_state)
    back = params_to_jax("mamba2", tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    own = mamba2.init_mamba2(torch.Generator().manual_seed(0), tcfg)
    assert sorted(own) == sorted(tp)
    for k in tp:
        assert own[k].shape == tp[k].shape, k
    # the deterministic leaves equal the reference's init
    for k in ("A_log", "D", "conv_b", "norm.scale", "norm_in.scale"):
        np.testing.assert_allclose(own[k].numpy(), tp[k].numpy(), rtol=1e-6)
    dt = torch.logaddexp(own["dt_bias"], torch.zeros(()))
    assert bool(((dt > 0.001 * 0.999) & (dt < 0.1 * 1.001)).all())
