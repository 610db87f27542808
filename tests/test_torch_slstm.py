"""The sLSTM half of ``repro_torch.models.xlstm`` against the JAX
package's ``repro.models.xlstm``, on weights carried over from the JAX
init: the cell through the block at S = 37 (the output and the final
state (c, n, h, m)), a 20-step prefill continued by decode steps to
S = 37, a state carried in from another prefix, the init's leaves and
the zero state, and the gradient of every leaf.

Tolerances: ``ATOL`` 1e-5 on the block's outputs and states (the sLSTM
cell's 37 dependent steps in float32; the JAX and torch products sum in
another order), ``GRAD_ATOL`` 1e-5 on the gradients, as
``tests/test_torch_lm_model.py``'s ``STEP_ATOL``."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

ATOL = 1e-5
GRAD_ATOL = 1e-5
S = 37


def _params(jp):
    """The JAX block's nested params as the port's nested dict."""
    return {k: ({"scale": torch.tensor(np.asarray(v["scale"]))}
                if isinstance(v, dict) else torch.tensor(np.asarray(v)))
            for k, v in jp.items()}


def _setup(d=64, h=4, b=2, s=S, seed=0):
    jcfg = JConfig(d_model=d, n_heads=h, n_kv_heads=h, d_ff=0)
    cfg = ModelConfig(d_model=d, n_heads=h, n_kv_heads=h, d_ff=0)
    jp = jx.init_slstm(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s, d)).astype(np.float32)
    return jcfg, cfg, jp, _params(jp), x


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=atol, err_msg=what)


@pytest.mark.parametrize("d,h", [(64, 4), (96, 2), (32, 1)])
def test_slstm_block_matches_reference(d, h):
    jcfg, cfg, jp, tp, x = _setup(d, h)
    want, wst = jx.slstm_block(jp, jcfg, jnp.asarray(x))
    got, st = tx.slstm_block(tp, cfg, torch.tensor(x))
    assert got.shape == (2, S, d)
    _close(got, want, what="block output")
    assert isinstance(st, tx.SLSTMState)
    for name in tx.SLSTMState._fields:
        _close(getattr(st, name), getattr(wst, name), what=name)
        assert getattr(st, name).shape == (2, h, d // h)


def test_slstm_prefill_then_decode_matches_reference_and_forward():
    jcfg, cfg, jp, tp, x = _setup()
    full, _ = tx.slstm_block(tp, cfg, torch.tensor(x))
    jy, jst = jx.slstm_block(jp, jcfg, jnp.asarray(x[:, :20]))
    y, st = tx.slstm_block(tp, cfg, torch.tensor(x[:, :20]))
    outs, jouts = [y], [np.asarray(jy)]
    for t in range(20, S):
        jy, jst = jx.slstm_block(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jst,
                                 decode=True)
        y, st = tx.slstm_block(tp, cfg, torch.tensor(x[:, t:t + 1]), st,
                               decode=True)
        outs.append(y)
        jouts.append(np.asarray(jy))
    got = torch.cat(outs, dim=1)
    _close(got, np.concatenate(jouts, axis=1), what="decode vs reference")
    _close(got, full.detach().numpy(), what="decode vs forward")
    for name in tx.SLSTMState._fields:
        _close(getattr(st, name), getattr(jst, name), what=name)
    with pytest.raises(ValueError, match="one step"):
        tx.slstm_block(tp, cfg, torch.tensor(x[:, :2]), st, decode=True)


def test_slstm_state_carried_from_a_prefix():
    """A prefill that starts from another sequence's final state."""
    jcfg, cfg, jp, tp, x = _setup()
    _, jst = jx.slstm_block(jp, jcfg, jnp.asarray(x[:, ::-1].copy()))
    st = tx.SLSTMState(*(torch.tensor(np.asarray(t)) for t in jst))
    want, wst = jx.slstm_block(jp, jcfg, jnp.asarray(x), jst)
    got, gst = tx.slstm_block(tp, cfg, torch.tensor(x), st)
    _close(got, want)
    for name in tx.SLSTMState._fields:
        _close(getattr(gst, name), getattr(wst, name), what=name)


def test_init_slstm_leaves_and_state():
    jcfg, cfg, jp, tp, _ = _setup()
    own = tx.init_slstm(torch.Generator().manual_seed(0), cfg)
    assert sorted(own) == sorted(jp)
    for k, v in jp.items():
        if isinstance(v, dict):
            assert torch.equal(own[k]["scale"], torch.ones(64))
        else:
            assert tuple(own[k].shape) == v.shape, k
    # the bias: z and i at 0, f at 3, o at 0
    assert torch.equal(own["b"], tp["b"])
    assert float(own["r"].std()) == pytest.approx(1 / 4, rel=0.1)
    st, jst = tx.init_slstm_state(cfg, 3), jx.init_slstm_state(jcfg, 3)
    for name in tx.SLSTMState._fields:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)))
    assert float(st.m.max()) == float(np.float32(-1e30))


def test_slstm_gradients_match_reference():
    jcfg, cfg, jp, tp, x = _setup(s=12)

    def jloss(p):
        y, _ = jx.slstm_block(p, jcfg, jnp.asarray(x))
        return jnp.sum(jnp.tanh(y))
    jg = jax.grad(jloss)(jp)
    leaves = {k: (v["scale"] if isinstance(v, dict) else v)
              for k, v in tp.items()}
    for v in leaves.values():
        v.requires_grad_(True)
    y, _ = tx.slstm_block(tp, cfg, torch.tensor(x))
    torch.sum(torch.tanh(y)).backward()
    for k, v in leaves.items():
        want = jg[k]["scale"] if isinstance(jg[k], dict) else jg[k]
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL, rtol=GRAD_ATOL,
                                   err_msg=k)
