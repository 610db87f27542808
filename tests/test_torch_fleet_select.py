"""The port's batched coreset selection against the JAX package's.

``kmedoids_batched_from_feats`` and ``build_coreset_batched`` run in both
packages on the same numpy feature stacks, with the distance-free cutover
at its default (``materialize_below=256``: these small groups take the
batched pairwise kernel and the D-input solver) and at 0 (every group
streams through the distance-free kernels).  On well-separated clusters
the medoids must be equal lane for lane.  On tie-heavy lanes (exact
duplicates, mostly padded lanes, k close to m) the reference itself
allows another tied optimum, so there the two medoid sets are scored by
the float64 objective (``medoid_objective_f64``) and must agree within
1e-5 relative.  The tie-free cohorts give each medoid a cluster of at
least three points: a two-point cluster is an exact tie (either point
is its medoid at the same cost), which float32 rounding breaks one way
or the other, and BUILD's later greedy picks then follow the break to
another local optimum.  Padded rows never win a medoid election.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import coreset as jcoreset  # noqa: E402
from repro.core import kmedoids as jk  # noqa: E402
from repro_torch.core import coreset as tcoreset  # noqa: E402
from repro_torch.core import kmedoids as tk  # noqa: E402

torch.set_num_threads(1)


def _cohort(seed, c, m_pad, f=6, n_clusters=5, tie_heavy=False):
    """A padded (C, M, F) cohort of clustered clients with ragged sizes,
    every cluster holding at least three points; padded rows repeat the
    last valid row, as ``make_cohort_groups`` pads them.  ``tie_heavy``
    duplicates every other point."""
    rng = np.random.default_rng(seed)
    x = np.zeros((c, m_pad, f), np.float32)
    valid = np.zeros((c, m_pad), bool)
    m_min = max(3 * n_clusters, m_pad // 3)
    for i in range(c):
        m = m_pad if i == 0 else int(rng.integers(m_min, m_pad + 1))
        centers = rng.normal(size=(n_clusters, f)) * 10.0
        xi = (centers[rng.permutation(np.arange(m) % n_clusters)]
              + rng.normal(size=(m, f))).astype(np.float32)
        if tie_heavy:
            xi[1::2] = xi[::2][: len(xi[1::2])]
        x[i, :m] = xi
        x[i, m:] = xi[-1]
        valid[i, :m] = True
    return x, valid


def _assert_same_or_tied(got_meds, want_meds, x, valid, allow_ties):
    for i in range(x.shape[0]):
        g, w = np.asarray(got_meds[i]), np.asarray(want_meds[i])
        assert valid[i, g].all(), f"lane {i}: a padded row won"
        if np.array_equal(g, w):
            continue
        assert allow_ties, f"lane {i}: medoids {g} != reference {w}"
        xv = x[i][valid[i]]
        np.testing.assert_allclose(tk.medoid_objective_f64(xv, g),
                                   tk.medoid_objective_f64(xv, w),
                                   rtol=1e-5, err_msg=f"lane {i}")


@pytest.mark.parametrize("materialize_below", [256, 0])
@pytest.mark.parametrize("seed,c,m_pad,k", [(0, 3, 40, 1), (1, 4, 64, 6),
                                            (2, 2, 33, 9)])
def test_build_coreset_batched_matches_reference(seed, c, m_pad, k,
                                                 materialize_below):
    x, valid = _cohort(seed, c, m_pad, n_clusters=max(k, 5))
    want = jcoreset.build_coreset_batched(
        jnp.asarray(x), jnp.asarray(valid), k,
        materialize_below=materialize_below)
    got = tcoreset.build_coreset_batched(
        torch.as_tensor(x), torch.as_tensor(valid), k,
        materialize_below=materialize_below)
    _assert_same_or_tied(got.indices.numpy(), np.asarray(want.indices), x,
                         valid, allow_ties=False)
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_allclose(got.objective.numpy(),
                               np.asarray(want.objective), rtol=1e-5)
    assert got.weights.dtype == torch.float32
    np.testing.assert_array_equal(got.weights.sum(1).numpy(),
                                  valid.sum(1))


@pytest.mark.parametrize("seed,k", [(3, 4), (4, 12)])
def test_from_feats_solver_on_tie_heavy_lanes(seed, k):
    """Duplicates and k close to the smallest lane's size: equal medoids
    or tied optima in the float64 objective, never a padded row."""
    x, valid = _cohort(seed, 4, 32, f=4, tie_heavy=True)
    xz = x * valid[..., None]            # the engine zeroes padded rows
    want = jk.kmedoids_batched_from_feats(jnp.asarray(xz), jnp.asarray(valid),
                                          k, max_sweeps=50)
    got = tk.kmedoids_batched_from_feats(torch.as_tensor(xz),
                                         torch.as_tensor(valid), k,
                                         max_sweeps=50)
    _assert_same_or_tied(got.medoids.numpy(), np.asarray(want.medoids), x,
                         valid, allow_ties=True)
    for i in range(4):
        m = int(valid[i].sum())
        assert int(got.weights[i].sum()) == m
        assert (got.assignment[i, m:] == -1).all()


def test_padded_lane_never_wins_medoid_election():
    """Zero-padded rows sit at the origin, mutually at distance 0.  Six
    valid points at ±5 on three axes are 5 from the origin but 7.07 from
    each other: without the +BIG candidate mask the origin (a padded row)
    would be the cheapest k = 1 medoid."""
    m, f = 32, 8
    x = np.zeros((1, m, f), np.float32)
    valid = np.zeros((1, m), bool)
    for i, (axis, sign) in enumerate([(0, 1), (0, -1), (1, 1), (1, -1),
                                      (2, 1), (2, -1)]):
        x[0, i, axis] = 5.0 * sign
        valid[0, i] = True
    for k in (1, 4):
        res = tk.kmedoids_batched_from_feats(torch.as_tensor(x),
                                             torch.as_tensor(valid), k)
        assert valid[0, res.medoids[0].numpy()].all()
        assert int(res.weights[0].sum()) == 6
        want = jk.kmedoids_batched_from_feats(jnp.asarray(x),
                                              jnp.asarray(valid), k)
        np.testing.assert_array_equal(res.medoids.numpy(),
                                      np.asarray(want.medoids))


def test_distance_free_and_d_input_paths_are_cost_tied():
    """The two solver paths of ``build_coreset_batched`` pick medoid sets
    of equal float64 objective (the D-input path runs below the cutover,
    ``materialize_below=0`` forces streaming)."""
    x, valid = _cohort(5, 3, 48, f=9)
    xt, vt = torch.as_tensor(x), torch.as_tensor(valid)
    dd = tcoreset.build_coreset_batched(xt, vt, 5)
    df = tcoreset.build_coreset_batched(xt, vt, 5, materialize_below=0)
    dn = tcoreset.build_coreset_batched(xt, vt, 5, distance_free=False,
                                        materialize_below=0)
    np.testing.assert_array_equal(dd.indices.numpy(), dn.indices.numpy())
    _assert_same_or_tied(df.indices.numpy(), dd.indices.numpy(), x, valid,
                         allow_ties=True)
