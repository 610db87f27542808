"""Kernels 5 and 6 (the distance-free BUILD and Δ-sweep) on the CPU: the
workspace plan and the two-pass decomposition the CUDA kernels run.

On the card a call computes the distances of a piece of the cohort into
a workspace of at most ``ops.FROM_FEATS_WORKSPACE_BYTES`` and then sums
over its rows in order, a band of rows continuing the sums of the band
before.  These tests hold (i) the planner, a pure function: every
(client, row) once, in order, no piece above the cap; (ii) the
decomposition, run piece by piece on the plain arithmetic with the sums
carried, equal to ``ref.kmedoids_*_from_feats_ref`` bit for bit at any
cap; (iii) that the kernel library's build hash covers the headers a
source includes.  The kernels themselves are held against the plain
versions on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref

torch.set_num_threads(1)


def _covers_once(c, m, cap, pieces):
    seen = np.zeros((c, m), dtype=np.int64)
    for c0, c1, r0, r1 in pieces:
        assert 0 <= c0 < c1 <= c and 0 <= r0 < r1 <= m
        assert 4 * (c1 - c0) * (r1 - r0) * m <= cap
        seen[c0:c1, r0:r1] += 1
    assert (seen == 1).all()
    # in order: clients ascending, a client's bands ascending
    assert pieces == sorted(pieces)


@pytest.mark.parametrize("c,m", [(1, 1), (1, 2048), (22, 256), (3, 512),
                                 (200, 16), (5, 37), (2, 4097)])
def test_plan_covers_each_row_once_within_the_cap(c, m):
    for cap in (ops.FROM_FEATS_WORKSPACE_BYTES, 4 * m * m * 2 + 4,
                4 * m * m, 4 * m * m - 1, 4 * m * 37, 4 * m):
        if cap < 4 * m:         # (m = 1: 4 m^2 - 1 holds no row)
            continue
        pieces = ops.from_feats_plan(c, m, cap)
        _covers_once(c, m, cap, pieces)
        if 4 * m * m <= cap:        # whole clients, as many as fit
            assert all(r0 == 0 and r1 == m for _, _, r0, r1 in pieces)
            assert len(pieces) == -(-c // (cap // (4 * m * m)))
        else:                       # one client at a time, in bands
            assert all(c1 - c0 == 1 for c0, c1, _, _ in pieces)
    with pytest.raises(ValueError, match="holds no row"):
        ops.from_feats_plan(c, m, 4 * m - 1)


def test_main_paths_run_in_one_piece():
    """The fleets' distance-free groups, (1, 2048) the largest, fit the
    cap whole: one distance pass and one reduction a call."""
    for c, m in [(1, 2048), (22, 256), (3, 512), (10, 256), (1, 1024),
                 (4, 512)]:
        assert ops.from_feats_plan(c, m, ops.FROM_FEATS_WORKSPACE_BYTES) \
            == [(0, c, 0, m)]


def _feats(c, m, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c, m, f)).astype(np.float32)
    vf = (rng.random((c, m)) < 0.8).astype(np.float32)
    vf[:, :2] = 1.0
    return torch.as_tensor(x * vf[..., None]), torch.as_tensor(vf)


def _band(x, sq, r0, r1):
    """Rows [r0, r1) of each client's distance matrix as the kernel's
    distance pass computes a band: the plain batched version's arithmetic
    (cross term over f in order, then the rounded epilogue) on the
    cohort's squared norms, the zero diagonal at the global index."""
    xb = x[:, r0:r1]
    cross = torch.zeros(x.shape[0], r1 - r0, x.shape[1])
    for k in range(x.shape[-1]):
        cross += xb[..., :, k, None] * x[..., None, :, k]
    d = torch.sqrt(torch.clamp_min(
        (sq[:, r0:r1, None] + sq[:, None, :]) - 2.0 * cross, 0.0))
    rows = torch.arange(r0, r1)[:, None]
    return torch.where(rows == torch.arange(x.shape[1])[None], 0.0, d)


def _two_pass(x, dn, d2, vf, onehot, cap):
    """Kernels 5 and 6 piece by piece, in their order: the distances of
    a piece, then every output's sum over the piece's rows in order,
    continued from the previous band's; the 1e30 masks at the end."""
    c, m, _ = x.shape
    sq = torch.sum(x * x, dim=-1)
    cost = torch.zeros(c, m)
    A = torch.zeros(c, m)
    B = torch.zeros(c, m, onehot.shape[-1])
    for c0, c1, r0, r1 in ops.from_feats_plan(c, m, cap):
        W = _band(x[c0:c1], sq[c0:c1], r0, r1)
        for r in range(r1 - r0):
            i = r0 + r
            w, lo, hi, v = (W[:, r], dn[c0:c1, i, None], d2[c0:c1, i, None],
                            vf[c0:c1, i, None])
            cost[c0:c1] += torch.minimum(lo, w) * v
            A[c0:c1] += (torch.minimum(w, lo) - lo) * v
            contrib = (torch.clamp(w, lo, hi) - lo) * v
            B[c0:c1] += contrib[..., :, None] * onehot[c0:c1, i, None, :]
    return (torch.where(vf > 0, cost, ref.BIG),
            torch.where(vf > 0, A, ref.BIG), B)


@pytest.mark.parametrize("c,m,f,k", [(3, 40, 33, 7), (2, 37, 60, 1),
                                     (4, 16, 5, 65)])
def test_two_pass_decomposition_equals_plain_at_any_cap(c, m, f, k):
    """Whole cohort, client chunks, and row bands of 1, 7 and 37 rows:
    the same bits as the plain versions."""
    x, vf = _feats(c, m, f, c * m + f + k)
    rng = np.random.default_rng(k)
    dn = torch.as_tensor(np.abs(rng.normal(size=(c, m))).astype(np.float32))
    d2 = dn + torch.as_tensor(
        np.abs(rng.normal(size=(c, m))).astype(np.float32))
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(rng.integers(0, k, size=(c, m))), k).float()
    want_cost = ref.kmedoids_build_cost_from_feats_ref(x, dn, vf)
    want_A, want_B = ref.kmedoids_delta_sweep_from_feats_ref(x, dn, d2, vf,
                                                             onehot)
    caps = (ops.FROM_FEATS_WORKSPACE_BYTES, 4 * m * m * 2, 4 * m * 37,
            4 * m * 7, 4 * m)
    for cap in caps:
        cost, A, B = _two_pass(x, dn, d2, vf, onehot, cap)
        assert torch.equal(cost, want_cost), cap
        assert torch.equal(A, want_A), cap
        assert torch.equal(B, want_B), cap


def test_private_launchers_refuse_cpu_tensors():
    """The launchers the card tests force small caps through need the
    card; they raise before building or launching anything."""
    x, vf = _feats(2, 8, 3, 0)
    with pytest.raises(ValueError, match="CUDA"):
        ops._build_cost_from_feats_launch(x, vf, vf, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ops._delta_sweep_from_feats_launch(x, vf, vf, vf,
                                           torch.ones(2, 8, 3), 64)


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every source that includes it, at any
    depth, and no other."""
    (tmp_path / "a.cu").write_text('#include "t.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <cuda_runtime.h>\nint b;\n")
    (tmp_path / "t.cuh").write_text('#pragma once\n#include "u.cuh"\n')
    (tmp_path / "u.cuh").write_text("#pragma once\n// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._source_files("a.cu") == ["a.cu", "t.cuh", "u.cuh"]
    assert _build._source_files("b.cu") == ["b.cu"]
    a0, b0 = _build._library_path("a.cu"), _build._library_path("b.cu")
    (tmp_path / "u.cuh").write_text("#pragma once\n// two\n")
    assert _build._library_path("a.cu") != a0
    assert _build._library_path("b.cu") == b0


def test_shipped_sources_hash_the_shared_tile_engine():
    """Both sources of the pairwise tile engine name its header."""
    for src in ("pairwise_l2.cu", "kmedoids_from_feats.cu"):
        assert "pairwise_tile.cuh" in _build._source_files(src)
