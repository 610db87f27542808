"""Kernel 8 (RMSNorm) on the CPU: the plain version the port runs here,
held against the JAX package.

``repro_torch.kernels.ops.rmsnorm`` takes its plain version
(``ref.rmsnorm_ref``, which sums in the CUDA kernel's fixed order) for a
tensor on the CPU.  It is held against the JAX Pallas op in interpret
mode and against the JAX oracle at the JAX kernel test's shapes and
tolerances (``_tol`` of ``tests/test_kernels.py``: 2e-5 in fp32, 2e-2 in
bf16), against a numpy float32 emulation of the kernel's summation order
bit for bit, with a grouped scale (one scale row per group of rows, the form
the fleet's vmapped step gives it), and its gradient (dx and dscale, the
``autograd.Function``'s PyTorch-ops backward) against ``jax.grad`` of
the JAX models' ``rmsnorm`` at 1e-5.  Under ``vmap(grad)`` with a
batched scale, an unbatched scale, or an unbatched x and a batched
scale, each example's gradient must equal its own outside ``vmap``.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

SHAPES = [(4, 37, 96), (256, 512), (1, 1, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(shape, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[-1]).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_rmsnorm_matches_pallas_and_oracle(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x, scale = _inputs(shape)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.tensor(x).to(tdt)
    # the same bf16 inputs on both sides
    np.testing.assert_array_equal(np.asarray(jx, np.float32),
                                  tx.float().numpy())
    got = ops.rmsnorm(tx, torch.tensor(scale))
    assert got.shape == tx.shape and got.dtype == tdt
    got = got.float().numpy()
    pallas = jops.rmsnorm(jx, jnp.asarray(scale), interpret=True)
    oracle = jref.rmsnorm_ref(jx, jnp.asarray(scale))
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol(dtype))


def _lane_order_rmsnorm(x, scale, vec, eps=1e-5):
    """numpy float32 emulation of the kernel's order for rows x (m, d)
    (float32 values) and scale (d,): V = ``vec`` elements a load (4 fp32,
    8 bf16); W = 1 warp a row up to 8 chunks of 32 V, else 8 warps; lane l
    of the row's 32 W lanes sums x_i^2, i = c*32WV + V*l + e, over chunks
    c and then e in order, one rounding a product and one a sum; each
    warp's lanes meet in a butterfly, the warps' sums add in order."""
    f = np.float32
    m, d = x.shape
    warps = 1 if d <= 8 * 32 * vec else 8
    lanes = 32 * warps
    chunk = lanes * vec
    y = np.empty((m, d), f)
    for r in range(m):
        acc = np.zeros(lanes, f)
        for lane in range(lanes):
            a = f(0)
            for c in range(-(-d // chunk)):
                for e in range(vec):
                    i = c * chunk + vec * lane + e
                    if i < d:
                        a = f(a + f(x[r, i] * x[r, i]))
            acc[lane] = a
        total = None
        for w in range(warps):
            s = acc[32 * w:32 * w + 32]
            while len(s) > 1:
                s = (s[:len(s) // 2] + s[len(s) // 2:]).astype(f)
            total = s[0] if total is None else f(total + s[0])
        rs = f(f(1) / f(np.sqrt(f(f(total * (f(1) / f(d))) + f(eps)))))
        y[r] = ((x[r] * rs).astype(f) * scale).astype(f)
    return y


@pytest.mark.parametrize("d", [1, 32, 37, 96, 4096, 4097])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_rmsnorm_repeats_the_kernel_lane_order(d, dtype):
    """Bit for bit with a numpy emulation of the CUDA kernel's summation
    order: short rows, one warp, eight warps, ragged tails."""
    _, tdt = DTYPES[dtype]
    rng = np.random.default_rng(d)
    x = torch.tensor(3.0 * rng.standard_normal((3, d)),
                     dtype=torch.float32).to(tdt)
    scale = rng.standard_normal(d).astype(np.float32)
    got = ref.rmsnorm_ref(x[None], torch.tensor(scale)[None])[0]
    want = _lane_order_rmsnorm(x.float().numpy(), scale,
                               vec=4 if dtype == "float32" else 8)
    assert torch.equal(got, torch.tensor(want).to(tdt))
    jx = jnp.asarray(x.float().numpy()).astype(DTYPES[dtype][0])
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jref.rmsnorm_ref(jx, jnp.asarray(scale)), np.float32),
        **_tol(dtype))


@pytest.mark.parametrize("g,m,d", [(3, 5, 40), (84, 8, 32), (2, 1, 7)])
def test_grouped_scale_matches_oracle_per_group(g, m, d):
    """Row r of group g uses scale[g]: the form the vmap rule folds the
    clients' scales into."""
    rng = np.random.default_rng(g * m + d)
    x = rng.standard_normal((g, m, d)).astype(np.float32)
    scale = rng.standard_normal((g, d)).astype(np.float32)
    got = ref.rmsnorm_ref(torch.tensor(x), torch.tensor(scale)).numpy()
    for i in range(g):
        want = jref.rmsnorm_ref(jnp.asarray(x[i]), jnp.asarray(scale[i]))
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("shape", [(4, 37, 96), (6, 16, 32), (3, 33)])
def test_gradient_matches_jax(shape):
    x, scale = _inputs(shape, seed=7)
    w = np.random.default_rng(8).standard_normal(shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jlayers.rmsnorm(p, x) * w)

    jdp, jdx = jax.grad(jloss, argnums=(0, 1))({"scale": jnp.asarray(scale)},
                                               jnp.asarray(x))

    def tloss(p, x):
        return torch.sum(tlayers.rmsnorm(p, x) * torch.tensor(w))

    tdp, tdx = grad(tloss, argnums=(0, 1))({"scale": torch.tensor(scale)},
                                           torch.tensor(x))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tdp["scale"].numpy(),
                               np.asarray(jdp["scale"]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("x_batched,scale_batched",
                         [(True, True), (True, False), (False, True)])
def test_vmap_of_grad_matches_per_example_loop(x_batched, scale_batched):
    """The fleet's vmapped step: every client's gradient through the
    vmap rule's folded groups equals the client's own, bit for bit (the
    plain forward and the backward are the same ops)."""
    rng = np.random.default_rng(11)
    n, b, s, d = 5, 4, 6, 40
    x = torch.tensor(rng.standard_normal((n, b, s, d)).astype(np.float32))
    scale = torch.tensor(rng.standard_normal((n, d)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((b, s, d)).astype(np.float32))

    def loss(x, scale):
        return torch.sum(ops.rmsnorm(x, scale) ** 2 * w)

    xs = x if x_batched else x[0]
    ss = scale if scale_batched else scale[0]
    dx, ds = vmap(grad(loss, argnums=(0, 1)),
                  in_dims=(0 if x_batched else None,
                           0 if scale_batched else None))(xs, ss)
    assert dx.shape == (n, b, s, d) and ds.shape == (n, d)
    for i in range(n):
        ex, es = grad(loss, argnums=(0, 1))(x[i] if x_batched else x[0],
                                            scale[i] if scale_batched
                                            else scale[0])
        assert torch.equal(dx[i], ex) and torch.equal(ds[i], es)


def test_layer_routes_through_the_op_and_the_switch():
    x, scale = _inputs((2, 5, 24))
    tx, p = torch.tensor(x), {"scale": torch.tensor(scale)}
    assert torch.equal(tlayers.rmsnorm(p, tx),
                       ref.rmsnorm_ref(tx.reshape(1, -1, 24),
                                       p["scale"][None]).reshape(tx.shape))
    assert torch.equal(tlayers.rmsnorm(p, tx, use_kernel=False),
                       tlayers.rmsnorm(p, tx))
    with pytest.raises(ValueError, match="CUDA"):
        tlayers.rmsnorm(p, tx, use_kernel=True)
    with pytest.raises(ValueError, match="scale"):
        ops.rmsnorm(tx, torch.ones(23))
