"""The port's chunked attention and KV-cache decode against the JAX
package's.

Chunked attention is held against the JAX chunked version on the
reference test's grid (window None / 9, kv heads 1 / 2 / 4) at S = 37
and S = 2048, where the JAX version pads nothing, and against the JAX
naive version at S = 1100: there the JAX chunked version pads k/v to
its 1024-key block and lets every query see the padded zero keys, so it
is wrong, and the port's is not."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.models.attention as jattn  # noqa: E402
import repro_torch.models.attention as tattn  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402

ATOL = 1e-5      # the reference's chunked-vs-naive tolerance
DECODE_ATOL = 2e-4


def _pair(kv_heads, d_model=64, n_heads=4, window=None):
    kw = dict(d_model=d_model, n_heads=n_heads, n_kv_heads=kv_heads,
              d_ff=128, vocab_size=100, attention_window=window)
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    jp = jattn.init_attention(jax.random.PRNGKey(0), jcfg)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("kv_heads", [1, 2, 4])
@pytest.mark.parametrize("s", [37, 2048])
def test_chunked_matches_reference_chunked(window, kv_heads, s):
    jcfg, tcfg, jp, tp = _pair(kv_heads)
    x = _x(1 if s > 1000 else 2, s, 64)
    want = jattn.multihead_attention(jp, jcfg, jnp.asarray(x), causal=True,
                                     window=window, impl="chunked")
    got = tattn.multihead_attention(tp, tcfg, torch.tensor(x), causal=True,
                                    window=window, impl="chunked")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_matches_reference_naive_at_a_ragged_long_s(causal):
    jcfg, tcfg, jp, tp = _pair(2, d_model=32, n_heads=2)
    x = _x(1, 1100, 32, seed=3)
    want = jattn.multihead_attention(jp, jcfg, jnp.asarray(x),
                                     causal=causal, impl="naive")
    got = tattn.multihead_attention(tp, tcfg, torch.tensor(x),
                                    causal=causal, impl="chunked")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)
    # the reference's chunked version attends to its padded keys here
    bad = jattn.multihead_attention(jp, jcfg, jnp.asarray(x), causal=causal,
                                    impl="chunked")
    assert float(np.max(np.abs(np.asarray(bad) - np.asarray(want)))) > 1e-2


def test_chunked_cross_attention_matches_reference():
    jcfg, tcfg, jp, tp = _pair(2)
    x, kv = _x(2, 19, 64), _x(2, 13, 64, seed=2)
    want = jattn.multihead_attention(jp, jcfg, jnp.asarray(x), causal=False,
                                     impl="chunked", kv_x=jnp.asarray(kv),
                                     use_rope=False)
    got = tattn.multihead_attention(tp, tcfg, torch.tensor(x), causal=False,
                                    impl="chunked", kv_x=torch.tensor(kv),
                                    use_rope=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("size", [4, 11])
def test_cache_slot_positions_match_reference(window, size):
    for pos in range(13):
        want = jattn.cache_slot_positions(size, jnp.asarray(pos, jnp.int32),
                                          window)
        got = tattn.cache_slot_positions(size, pos, window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_matches_reference(window):
    """Nine tokens through the cache one at a time, a ring of 4 slots
    under the window: each step's output and the cache against the
    reference's, and the outputs against the full-sequence attention."""
    jcfg, tcfg, jp, tp = _pair(2, window=window)
    s = 9
    x = _x(2, s, 64, seed=4)
    jc = jattn.init_kv_cache(jcfg, 1, 2, s, jnp.float32)
    tc = tattn.init_kv_cache(tcfg, 1, 2, s, torch.float32)
    assert tuple(tc["k"].shape) == jc["k"].shape
    jk, jv, tk, tv = jc["k"][0], jc["v"][0], tc["k"][0], tc["v"][0]
    outs = []
    for t in range(s):
        jo, jk, jv = jattn.attention_decode(
            jp, jcfg, jnp.asarray(x[:, t:t + 1]), jk, jv,
            jnp.asarray(t, jnp.int32), window=window)
        to, tk2, tv2 = tattn.attention_decode(
            tp, tcfg, torch.tensor(x[:, t:t + 1]), tk, tv, t, window=window)
        assert tk2 is tk and tv2 is tv          # written in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                                   atol=DECODE_ATOL, rtol=DECODE_ATOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
        outs.append(to)
    full = tattn.multihead_attention(tp, tcfg, torch.tensor(x), causal=True,
                                     window=window, impl="naive")
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=DECODE_ATOL, rtol=DECODE_ATOL)
