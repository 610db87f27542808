"""Kernel 7's module against the JAX package: flash attention, its
gradient and vmap rule, and the attention layer around it.

The port's ``ops.flash_attention`` on CPU tensors runs its plain version
(``kernels/ref.py::flash_attention_ref``, the CUDA kernel's arithmetic)
through the same ``autograd.Function`` that carries every call on the
card.  It is held against the JAX package's Pallas kernel in interpret
mode and against its oracle at the JAX kernel tests' shapes and
tolerances (rtol = atol = 2e-5 in float32, 2e-2 in bf16:
``tests/test_kernels.py::_tol``); its gradient against ``jax.grad`` of
the oracle at atol 1e-5 (the JAX Pallas kernel has no VJP); and its
``vmap`` rule against a per-example loop.  The layers (RMSNorm, RoPE,
both MLP activations, ``ModelConfig``) and ``multihead_attention`` in
both implementations run on the same weights as the JAX ones, at atol
1e-5.  Inputs come from numpy seeds.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5


def _tol(dtype):
    """The JAX kernel tests' tolerance (``tests/test_kernels.py``)."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _qkv(seed, b, hq, hk, s, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, hd)).astype(np.float32),
            rng.standard_normal((b, hk, s, hd)).astype(np.float32),
            rng.standard_normal((b, hk, s, hd)).astype(np.float32))


# (b, hq, hk, s, hd, window, dtype): the JAX tests' GQA shapes, windows and
# dtypes, and one ragged S (no multiple of the kernel's 64-key tile)
CASES = [(2, 4, 2, 128, 64, None, "float32"),
         (1, 4, 4, 256, 32, None, "float32"),
         (2, 8, 1, 128, 64, None, "float32"),
         (1, 2, 2, 64, 128, None, "float32"),
         (1, 4, 2, 128, 64, 16, "float32"),
         (1, 4, 2, 128, 64, 48, "float32"),
         (1, 4, 2, 128, 64, 128, "float32"),
         (1, 2, 2, 128, 64, None, "float32"),
         (1, 2, 2, 128, 64, None, "bfloat16"),
         (2, 4, 2, 40, 16, None, "float32"),
         (2, 4, 2, 40, 16, 7, "float32")]


@pytest.mark.parametrize("b,hq,hk,s,hd,window,dtype", CASES)
def test_plain_flash_attention_matches_pallas_and_oracle(b, hq, hk, s, hd,
                                                         window, dtype):
    q, k, v = _qkv(b * hq + s + hd, b, hq, hk, s, hd)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.tensor(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    pallas = jops.flash_attention(jq, jk, jv, window=window, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, window=window)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol(dtype))
    np.testing.assert_array_equal(
        got, ref.flash_attention_ref(tq, tk, tv, window=window)
        .float().numpy())


# bf16 cases of the tensor-core path's plain version: GQA, windows, a
# ragged S and the narrowest and widest head dims
BF16_CASES = [(2, 4, 2, 128, 64, None), (1, 4, 2, 128, 64, 48),
              (2, 4, 2, 40, 16, None), (2, 4, 2, 40, 16, 7),
              (1, 2, 2, 64, 128, None), (2, 8, 1, 128, 64, 16)]


@pytest.mark.parametrize("b,hq,hk,s,hd,window", BF16_CASES)
def test_plain_bf16_attention_rounds_p_and_matches_pallas(b, hq, hk, s, hd,
                                                          window):
    """The plain bf16 version rounds each tile's P to bf16 before P.V, as
    the tensor-core kernel does, and stays within the JAX kernel tests'
    bf16 tolerance of the Pallas kernel (interpret mode, fp32 P) and of
    the oracle; it is exactly the fp32 arithmetic on the bf16 inputs but
    for that rounding (both P's differ by at most half a bf16 ulp)."""
    q, k, v = _qkv(b * hq + s + hd + 1, b, hq, hk, s, hd)
    jq, jk, jv = (jnp.asarray(a).astype("bfloat16") for a in (q, k, v))
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    got = got.float().numpy()
    pallas = jops.flash_attention(jq, jk, jv, window=window, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, window=window)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol("bfloat16"))
    # the fp32 path on the same (bf16-valued) inputs keeps P in fp32
    fp32 = ref.flash_attention_ref(tq.float(), tk.float(), tv.float(),
                                   window=window)
    np.testing.assert_allclose(got, fp32.numpy(), **_tol("bfloat16"))
    assert not np.array_equal(got, fp32.to(torch.bfloat16).float().numpy())


def test_non_causal_and_scale_match_oracle():
    q, k, v = _qkv(5, 1, 4, 2, 96, 32)
    got = ops.flash_attention(*map(torch.tensor, (q, k, v)), causal=False,
                              window=20, scale=0.3)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=False, window=20, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(""))


@pytest.mark.parametrize("b,hq,hk,s,hd,causal,window",
                         [(2, 4, 2, 64, 32, True, None),
                          (1, 4, 2, 80, 32, True, 16),
                          (2, 8, 1, 64, 16, True, None),
                          (1, 2, 2, 48, 16, False, None)])
def test_gradient_matches_jax_grad_of_oracle(b, hq, hk, s, hd, causal,
                                             window):
    """The JAX Pallas kernel has no VJP: the reference gradient is
    ``jax.grad`` of its oracle, under a random cotangent."""
    q, k, v = _qkv(s + hd, b, hq, hk, s, hd)
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jref.flash_attention_ref(
            q, k, v, causal=causal, window=window) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    torch.sum(out * torch.tensor(w)).backward()
    for got, ref_g in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_g), atol=ATOL)


def test_vmap_of_grad_matches_per_example_loop():
    """The fleet engine's vmapped step: ``vmap(grad_and_value(...))``
    through the op folds the client axis into B (the Function's vmap
    rule) and must give each client's own gradient and loss; the two sum
    in the same order, so 1e-6 only covers a batched matrix product in
    the backward."""
    rng = np.random.default_rng(2)
    c, b, hq, hk, s, hd = 3, 2, 4, 2, 40, 16
    q = torch.tensor(rng.standard_normal((c, b, hq, s, hd)),
                     dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((c, b, hk, s, hd)),
                     dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((b, hq, s, hd)),
                     dtype=torch.float32)

    def loss(q, k, v):
        return torch.sum(ops.flash_attention(q, k, v, window=9) * w)

    step = grad_and_value(loss, argnums=(0, 1, 2))
    # v shared by every client: an unbatched input of the vmap rule
    v = k[0] * 0.5
    grads, vals = vmap(step, in_dims=(0, 0, None))(q, k, v)
    for i in range(c):
        g, val = step(q[i], k[i], v)
        np.testing.assert_allclose(vals[i].item(), val.item(), atol=1e-6)
        for a, bb in zip(grads, g):
            np.testing.assert_allclose(a[i].numpy(), bb.numpy(), atol=1e-6)


def test_kernel_switch_follows_the_device_rule():
    q, k, v = map(torch.tensor, _qkv(1, 1, 2, 2, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, use_kernel=True)
    before = dict(ops.LAUNCHES)
    ops.flash_attention(q, k, v)
    ops.flash_attention(q, k, v, use_kernel=False)
    assert ops.LAUNCHES == before and "flash_attention" in before


# ---------------------------------------------------------------------------
# the layers around it
# ---------------------------------------------------------------------------

def test_model_config_copy_matches_reference():
    for kw in (dict(d_model=32, n_heads=2, n_kv_heads=2),
               dict(d_model=96, n_heads=6, n_kv_heads=2),
               dict(d_model=64, n_heads=4, d_head=24)):
        a, b = ModelConfig(**kw), JModelConfig(**kw)
        assert (a.d_head, a.q_per_kv) == (b.d_head, b.q_per_kv)
    with pytest.raises(ValueError, match="not divisible"):
        ModelConfig(n_heads=6, n_kv_heads=4)


def test_rmsnorm_rope_and_mlp_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 10, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rmsnorm({"scale": torch.tensor(scale)},
                        torch.tensor(x)).numpy(),
        np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                                   jnp.asarray(x))), atol=ATOL)
    h = rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
    pos = np.arange(3, 13, dtype=np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.tensor(h), torch.tensor(pos),
                           10000.0).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(h), jnp.asarray(pos),
                                      10000.0)), atol=ATOL)
    for act in ("silu", "gelu"):
        jp = jax.tree.map(np.asarray, jlayers.init_mlp(
            jax.random.PRNGKey(1), JModelConfig(d_model=32, act=act),
            d_ff=48))
        assert set(jp) == set(tlayers.init_mlp(
            torch.Generator().manual_seed(0), ModelConfig(d_model=32,
                                                          act=act), d_ff=48))
        np.testing.assert_allclose(
            tlayers.mlp({k: torch.tensor(v) for k, v in jp.items()},
                        torch.tensor(x), act=act).numpy(),
            np.asarray(jlayers.mlp(jp, jnp.asarray(x), act=act)), atol=ATOL)


@pytest.mark.parametrize("window", [None, 5])
def test_multihead_attention_matches_reference(window):
    """``naive`` against the JAX ``naive``, ``kernel`` (the plain forward
    here) against the JAX ``pallas`` (interpret mode), GQA with RoPE."""
    jcfg = JModelConfig(d_model=32, n_heads=4, n_kv_heads=2)
    cfg = ModelConfig(d_model=32, n_heads=4, n_kv_heads=2)
    jp = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(2), jcfg))
    tp = {k: torch.tensor(v) for k, v in jp.items()}
    x = np.random.default_rng(6).standard_normal((3, 16, 32)).astype(
        np.float32)
    for impl, jimpl in (("naive", "naive"), ("kernel", "pallas")):
        got = tattn.multihead_attention(tp, cfg, torch.tensor(x),
                                        window=window, impl=impl)
        want = jattn.multihead_attention(jp, jcfg, jnp.asarray(x),
                                         window=window, impl=jimpl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=impl)
    # cross-attention takes the chunked path under impl="kernel"
    kv = np.random.default_rng(7).standard_normal((3, 12, 32)).astype(
        np.float32)
    want = jattn.multihead_attention(jp, jcfg, jnp.asarray(x), causal=False,
                                     impl="naive", kv_x=jnp.asarray(kv))
    for impl in ("naive", "kernel"):
        got = tattn.multihead_attention(tp, cfg, torch.tensor(x),
                                        causal=False, impl=impl,
                                        kv_x=torch.tensor(kv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_unknown_attention_impl_raises():
    cfg = ModelConfig(d_model=32, n_heads=2, n_kv_heads=2)
    p = tattn.init_attention(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.multihead_attention(p, cfg, x, impl="pallas")
