"""The port's plain kernel versions against the JAX Pallas kernels.

Each plain PyTorch version in ``repro_torch.kernels.ref`` (what the
wrappers in ``repro_torch.kernels.ops`` run for CPU tensors) is held
against the JAX op run through its Pallas kernel in interpret mode, on
the same numpy inputs: ragged m, d not a multiple of 128, k = 1, K > 1
and masked ``vf``.  Tolerance rtol = atol = 1e-5: the two sum in float32
in different orders.  The CUDA kernels themselves are held against these
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,d", [(37, 60), (21, 200), (64, 128)])
def test_pairwise_l2_matches_pallas(m, d):
    x = np.random.default_rng(m + d).normal(size=(m, d)).astype(np.float32)
    want = np.asarray(jops.pairwise_l2(jnp.asarray(x), squared=True,
                                       zero_diag=True, interpret=True))
    got = ops.pairwise_l2(torch.as_tensor(x), squared=True, zero_diag=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (np.diag(got.numpy()) == 0.0).all()
    # Euclidean (sqrt) form against the plain version's own squared form
    d_e = ref.pairwise_l2_ref(torch.as_tensor(x))
    np.testing.assert_allclose(
        d_e.numpy(), np.sqrt(ref.pairwise_l2_ref(torch.as_tensor(x),
                                                 squared=True).numpy()),
        **TOL)


@pytest.mark.parametrize("c,m", [(1, 37), (2, 21), (3, 64)])
def test_build_cost_matches_pallas(c, m):
    rng = np.random.default_rng(c * 100 + m)
    D = np.abs(rng.normal(size=(c, m, m))).astype(np.float32)
    d_near = np.abs(rng.normal(size=(c, m))).astype(np.float32)
    vf = (rng.random((c, m)) < 0.8).astype(np.float32)
    want = np.asarray(jops.kmedoids_build_cost(
        jnp.asarray(D), jnp.asarray(d_near), jnp.asarray(vf),
        use_kernel=True, interpret=True))
    got = ops.kmedoids_build_cost(torch.as_tensor(D),
                                  torch.as_tensor(d_near),
                                  torch.as_tensor(vf))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c,m,k", [(1, 37, 1), (2, 21, 7), (1, 64, 130)])
def test_delta_sweep_matches_pallas(c, m, k):
    rng = np.random.default_rng(c * 1000 + m + k)
    D = np.abs(rng.normal(size=(c, m, m))).astype(np.float32)
    d1 = np.abs(rng.normal(size=(c, m))).astype(np.float32)
    d2 = d1 + np.abs(rng.normal(size=(c, m))).astype(np.float32)  # d1 <= d2
    onehot = np.eye(k, dtype=np.float32)[rng.integers(0, k, size=(c, m))]
    vf = (rng.random((c, m)) < 0.8).astype(np.float32)
    args = (D, d1, d2, vf, onehot)
    A_want, B_want = jops.kmedoids_delta_sweep(
        *map(jnp.asarray, args), use_kernel=True, interpret=True)
    A, B = ops.kmedoids_delta_sweep(*map(torch.as_tensor, args))
    np.testing.assert_allclose(A.numpy(), np.asarray(A_want), **TOL)
    np.testing.assert_allclose(B.numpy(), np.asarray(B_want), **TOL)
    assert B.shape == (c, m, k)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(9, 5, generator=torch.Generator().manual_seed(0))
    D = ops.pairwise_l2(x, squared=True, zero_diag=True)[None]
    ops.kmedoids_build_cost(D, D[:, 0], torch.ones(1, 9))
    ops.kmedoids_delta_sweep(D, D[:, 0], D[:, 1], torch.ones(1, 9),
                             torch.ones(1, 9, 2))
    xb = x[None]
    ops.pairwise_l2_batched(xb, zero_diag=True)
    ops.kmedoids_build_cost_from_feats(xb, D[:, 0], torch.ones(1, 9))
    ops.kmedoids_delta_sweep_from_feats(xb, D[:, 0], D[:, 1],
                                        torch.ones(1, 9), torch.ones(1, 9, 2))
    q = x.reshape(1, 1, 9, 5)
    ops.flash_attention(q, q, q)
    ops.rmsnorm(x, torch.ones(5))
    assert ops.LAUNCHES == dict.fromkeys(
        ("pairwise_l2", "build_cost", "delta_sweep", "pairwise_l2_batched",
         "build_cost_from_feats", "delta_sweep_from_feats",
         "flash_attention", "rmsnorm"), 0)


def test_use_kernel_true_on_a_cpu_tensor_raises():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.pairwise_l2(x, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.kmedoids_build_cost(torch.zeros(1, 4, 4), torch.zeros(1, 4),
                                torch.zeros(1, 4), use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm(x, torch.ones(3), use_kernel=True)
    assert ops.resolve_use_kernel(None, torch.device("cpu")) is False
    assert ops.resolve_use_kernel(False, torch.device("cpu")) is False
