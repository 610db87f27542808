"""The port's k-medoids solver against the JAX package's.

On seeded well-separated data the port's ``kmedoids_jax`` picks the
same medoids as ``repro.core.kmedoids.kmedoids_jax`` and the float64
``kmedoids_numpy`` oracle.  On tie-heavy data (duplicate points, a
budget close to m) tied optima may differ by index, so the medoid sets
are scored by the float64 objective and must agree within 1e-5 relative.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import coreset as jcoreset  # noqa: E402
from repro.core import kmedoids as jk  # noqa: E402
from repro_torch.core import coreset as tcoreset  # noqa: E402
from repro_torch.core import gradients as tgradients  # noqa: E402
from repro_torch.core import kmedoids as tk  # noqa: E402

torch.set_num_threads(1)


def _clusters(seed, m, d=6, n_clusters=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 10.0
    x = centers[rng.integers(0, n_clusters, size=m)] + rng.normal(size=(m, d))
    return x.astype(np.float32)


def _distances(x):
    """The same float32 distance matrix for both solvers."""
    return np.sqrt(np.maximum(
        tk.pairwise_sq_dists(torch.as_tensor(x)).numpy(), 0.0))


@pytest.mark.parametrize("seed,m,k", [(0, 40, 1), (2, 57, 9)])
def test_medoids_match_jax_and_numpy_on_separated_data(seed, m, k):
    D = _distances(_clusters(seed, m))
    want = jk.kmedoids_jax(jnp.asarray(D), k)
    got = tk.kmedoids_jax(torch.as_tensor(D), k)
    oracle = jk.kmedoids_numpy(D, k)
    np.testing.assert_array_equal(got.medoids.numpy(),
                                  np.asarray(want.medoids))
    # the f64 oracle may fill the medoid slots in another order
    np.testing.assert_array_equal(np.sort(got.medoids.numpy()),
                                  np.sort(np.asarray(oracle.medoids)))
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=1e-6)
    # the port's own float64 oracle is the reference's
    port_oracle = tk.kmedoids_numpy(D, k)
    np.testing.assert_array_equal(port_oracle.medoids.numpy(),
                                  np.asarray(oracle.medoids))


@pytest.mark.parametrize("seed,m,k", [(3, 33, 12), (5, 24, 20)])
def test_tied_optima_agree_in_f64_objective(seed, m, k):
    """Duplicate points, mirror-image pairs and k close to m: the medoid
    sets may differ by tied indices, never by objective (seed 3 holds an
    exact float64 tie at its fifth BUILD pick, which the two float32 sum
    orders break differently)."""
    x = _clusters(seed, m, d=6 if seed == 3 else 4)
    if seed != 3:
        x[1::2] = x[::2][: len(x[1::2])]           # exact duplicates
    D = _distances(x)
    want = jk.kmedoids_jax(jnp.asarray(D), k)
    got = tk.kmedoids_jax(torch.as_tensor(D), k)
    f_want = tk.medoid_objective_f64(x, np.asarray(want.medoids))
    f_got = tk.medoid_objective_f64(x, got.medoids.numpy())
    np.testing.assert_allclose(f_got, f_want, rtol=1e-5)
    assert int(got.weights.sum()) == m


def test_batched_masked_lanes_equal_standalone_solves():
    """The leading client axis: each masked lane of one batched solve
    equals its standalone unpadded solve; padding never wins a medoid."""
    m_pad, k = 24, 4
    Ds, valids, solo = [], [], []
    for seed, m in ((7, 24), (8, 17), (9, 11)):
        D = _distances(_clusters(seed, m))
        Dp = np.full((m_pad, m_pad), 3.0, np.float32)
        Dp[:m, :m] = D
        Ds.append(Dp)
        valids.append(np.arange(m_pad) < m)
        solo.append(tk.kmedoids_jax(torch.as_tensor(D), k))
    res = tk.kmedoids_batched(torch.as_tensor(np.stack(Ds)),
                              torch.as_tensor(np.stack(valids)), k)
    for c, want in enumerate(solo):
        np.testing.assert_array_equal(res.medoids[c].numpy(),
                                      want.medoids.numpy())
        m = int(valids[c].sum())
        assert (res.assignment[c, m:] == -1).all()
        assert int(res.weights[c].sum()) == m


def test_argmin_breaks_ties_to_the_first_index():
    """BUILD and SWAP rely on first-index ties, as jnp.argmin has them."""
    v = torch.tensor([[3.0, 1.0, 1.0, 1.0], [2.0, 2.0, 0.5, 0.5]])
    assert torch.argmin(v, dim=1).tolist() == [1, 2]
    assert int(torch.argmin(torch.zeros(1000))) == 0
    assert int(torch.argmin(torch.full((5, 7), 1e30).reshape(-1))) == 0


def test_build_coreset_matches_reference_and_numpy_backend():
    x = _clusters(10, 45, d=8)
    want = jcoreset.build_coreset(jnp.asarray(x), 6)
    got = tcoreset.build_coreset(torch.as_tensor(x), 6)
    got_np = tcoreset.build_coreset(torch.as_tensor(x), 6, backend="numpy")
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got_np.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    assert got.weights.dtype == torch.float32
    assert float(got.weights.sum()) == 45.0
    # projection_dim projects the features first (JL, F = 8 -> 4), and is
    # a no-op at F or above
    proj = tcoreset.build_coreset(torch.as_tensor(x), 6, projection_dim=4)
    want_proj = tcoreset.build_coreset(
        tgradients.project_features(torch.as_tensor(x), 4), 6)
    np.testing.assert_array_equal(proj.indices.numpy(),
                                  want_proj.indices.numpy())
    assert float(proj.weights.sum()) == 45.0
    same = tcoreset.build_coreset(torch.as_tensor(x), 6, projection_dim=8)
    np.testing.assert_array_equal(same.indices.numpy(), got.indices.numpy())
