"""The port's plain versions of kernels 4-6 against the JAX package.

Each plain PyTorch version in ``repro_torch.kernels.ref`` (what the
wrappers in ``repro_torch.kernels.ops`` run for CPU tensors) is held, on
the same numpy inputs, against the JAX op run through its Pallas kernel
in interpret mode and against the JAX package's own ``kernels/ref.py``
oracles, as ``tests/test_distance_free.py`` runs them: odd shapes such as
(C, M, F) = (2, 40, 129), zero-padded rows, K in {1, 7, 33}.  Tolerance
rtol = atol = 1e-5: the two packages sum in float32 in different orders.
Padded candidates (vf = 0) must carry exactly 1e30 on both sides.  The
CUDA kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
BIG = np.float32(1e30)


def _masked_feats(rng, c, m, f, p_valid=0.8):
    """(C, M, F) features with zero-padded invalid rows, as the fleet
    engine hands them to the distance-free kernels."""
    x = rng.normal(size=(c, m, f)).astype(np.float32)
    vf = (rng.random((c, m)) < p_valid).astype(np.float32)
    vf[:, :2] = 1.0                     # at least two valid rows per lane
    return x * vf[..., None], vf


@pytest.mark.parametrize("c,m,d", [(2, 40, 129), (3, 37, 60), (1, 64, 16),
                                   (4, 8, 3)])
def test_pairwise_l2_batched_matches_pallas(c, m, d):
    x = np.random.default_rng(c + m + d).normal(size=(c, m, d)).astype(
        np.float32)
    want = np.asarray(jops.pairwise_l2_batched(
        jnp.asarray(x), squared=False, use_kernel=True, zero_diag=True,
        interpret=True))
    got = ops.pairwise_l2_batched(torch.as_tensor(x), zero_diag=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (np.diagonal(got.numpy(), axis1=1, axis2=2) == 0.0).all()
    # each client's matrix is the single-matrix plain version's
    for i in range(c):
        np.testing.assert_array_equal(
            ref.pairwise_l2_batched_ref(torch.as_tensor(x))[i].numpy(),
            ref.pairwise_l2_ref(torch.as_tensor(x[i])).numpy())
    # squared form against the JAX oracle, off the diagonal (there both
    # sides hold only float32 cancellation residue of size |x|²·eps)
    sq = ops.pairwise_l2_batched(torch.as_tensor(x), squared=True)
    want_sq = np.stack([np.asarray(jref.pairwise_l2_ref(jnp.asarray(xi),
                                                        squared=True))
                        for xi in x])
    off = ~np.eye(m, dtype=bool)
    np.testing.assert_allclose(sq.numpy()[:, off], want_sq[:, off], **TOL)


@pytest.mark.parametrize("c,m,f", [(2, 40, 129), (3, 64, 16), (1, 128, 60),
                                   (4, 8, 3), (2, 21, 10)])
def test_build_cost_from_feats_matches_pallas(c, m, f):
    rng = np.random.default_rng(c * 100 + m + f)
    x, vf = _masked_feats(rng, c, m, f)
    d_near = np.abs(rng.normal(size=(c, m))).astype(np.float32)
    args = (x, d_near, vf)
    want_k = np.asarray(jops.kmedoids_build_cost_from_feats(
        *map(jnp.asarray, args), use_kernel=True, interpret=True))
    want_ref = np.asarray(jref.kmedoids_build_cost_from_feats_ref(
        *map(jnp.asarray, args)))
    got = ops.kmedoids_build_cost_from_feats(*map(torch.as_tensor, args))
    for want in (want_k, want_ref):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # padded candidates are exactly +BIG on both sides, valid ones finite
    assert (got.numpy()[vf == 0] == BIG).all()
    assert (want_k[vf == 0] == BIG).all()
    assert (got.numpy()[vf > 0] < 1e29).all()


@pytest.mark.parametrize("c,m,f,k", [(2, 40, 129, 7), (3, 64, 16, 1),
                                     (1, 128, 60, 33), (4, 32, 7, 3)])
def test_delta_sweep_from_feats_matches_pallas(c, m, f, k):
    rng = np.random.default_rng(c * 1000 + m + f + k)
    x, vf = _masked_feats(rng, c, m, f)
    d1 = np.abs(rng.normal(size=(c, m))).astype(np.float32)
    d2 = d1 + np.abs(rng.normal(size=(c, m))).astype(np.float32)
    onehot = np.eye(k, dtype=np.float32)[rng.integers(0, k, size=(c, m))]
    args = (x, d1, d2, vf, onehot)
    A_k, B_k = jops.kmedoids_delta_sweep_from_feats(
        *map(jnp.asarray, args), use_kernel=True, interpret=True)
    A_r, B_r = jref.kmedoids_delta_sweep_from_feats_ref(
        *map(jnp.asarray, args))
    A, B = ops.kmedoids_delta_sweep_from_feats(*map(torch.as_tensor, args))
    assert B.shape == (c, m, k)
    for A_want, B_want in ((A_k, B_k), (A_r, B_r)):
        np.testing.assert_allclose(A.numpy(), np.asarray(A_want), **TOL)
        np.testing.assert_allclose(B.numpy(), np.asarray(B_want), **TOL)
    # padded candidates carry +BIG removal gain: they can never win a swap
    assert (A.numpy()[vf == 0] == BIG).all()
    assert (np.asarray(A_k)[vf == 0] == BIG).all()


def test_from_feats_plain_versions_are_the_materialized_reductions():
    """The distance-free plain versions equal the batched pairwise plain
    version followed by the D-input plain reductions, bit for bit: the
    arithmetic the CUDA kernels repeat."""
    rng = np.random.default_rng(11)
    x, vf = _masked_feats(rng, 2, 40, 129)
    x, vf = torch.as_tensor(x), torch.as_tensor(vf)
    D = ops.pairwise_l2_batched(x, zero_diag=True)
    dn = torch.as_tensor(np.abs(rng.normal(size=(2, 40))).astype(np.float32))
    cost = ops.kmedoids_build_cost_from_feats(x, dn, vf)
    want = torch.where(vf > 0, ops.kmedoids_build_cost(D, dn, vf), BIG)
    assert torch.equal(cost, want)
    d2 = dn + 1.0
    oh = torch.nn.functional.one_hot(
        torch.as_tensor(rng.integers(0, 7, size=(2, 40))), 7).float()
    A, B = ops.kmedoids_delta_sweep_from_feats(x, dn, d2, vf, oh)
    A_d, B_d = ops.kmedoids_delta_sweep(D, dn, d2, vf, oh)
    assert torch.equal(A, torch.where(vf > 0, A_d, BIG))
    assert torch.equal(B, B_d)


def test_new_wrappers_refuse_use_kernel_on_cpu():
    x = torch.zeros(1, 4, 3)
    v = torch.ones(1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ops.pairwise_l2_batched(x, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.kmedoids_build_cost_from_feats(x, v, v, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.kmedoids_delta_sweep_from_feats(x, v, v, v, torch.ones(1, 4, 2),
                                            use_kernel=True)
