"""Kernels 2 and 3 (the BUILD add-cost and the Δ-sweep over a stored D)
on the CPU: the order of the arithmetic their CUDA kernels run.

On the card kernel 2 and kernel 3's A are the column walk of
``csrc/column_walk.cuh`` (every row in increasing i, 32 rows a stage, no
padded-candidate mask), and kernel 3's B is summed over slot lists: for
each slot l the rows i with H[i, l] != 0, in increasing i, and one term
``contrib_ij * H_il`` for each.  These tests hold float32 numpy
emulations of those reductions, and a plain twin of the slot-list pass
(its 32 row ranges, the scan of their counts, the stable lists), equal
bit for bit to the unchanged plain versions ``ref.kmedoids_build_cost_ref``
and ``ref.kmedoids_delta_sweep_ref`` for one-hot, multi-nonzero and dense
H and C > 1.  They also check that every entry point's C signature has
the argument types ``_build`` gives it, and that the build hash covers
the headers the sources share.  The kernels themselves are held against
the plain versions on the card (``tests/test_torch_cuda.py``).
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref

torch.set_num_threads(1)

WALK_ROWS = 32      # rows a stage of the walk (column_walk.cuh kRows)
SLOT_RANGES = 32    # row ranges of a slot-list block (kSlotWarps)


def _walk(D, p, v, build):
    """The column walk: every output sums over the rows in increasing i,
    a stage of 32 rows at a time, a rounded product and a rounded add a
    term: BUILD min(p_i, D_ij) * v_i, A (min(D_ij, p_i) - p_i) * v_i."""
    c, m, _ = D.shape
    out = np.zeros((c, m), np.float32)
    for i0 in range(0, m, WALK_ROWS):
        for i in range(i0, min(m, i0 + WALK_ROWS)):
            w, pi, vi = D[:, i, :], p[:, i, None], v[:, i, None]
            term = (np.minimum(pi, w) * vi if build
                    else (np.minimum(w, pi) - pi) * vi)
            out = out + term
    return out


def slot_lists(H):
    """The slot-list pass's plain twin: (rows (C, K, M) int32, counts (C,
    K) int32), ``rows[c, l, :counts[c, l]]`` the rows i with H[c, i, l]
    != 0 in increasing i (-1 past the count, where the kernel leaves the
    buffer as it was).  As the kernel builds them: the M rows in 32
    ranges, each range's nonzeros counted, the counts scanned into each
    range's offset, each range's rows written from its offset."""
    c, m, k = H.shape
    rows = np.full((c, k, m), -1, np.int32)
    counts = np.zeros((c, k), np.int32)
    per = -(-m // SLOT_RANGES)
    ranges = [(min(m, w * per), min(m, w * per + per))
              for w in range(SLOT_RANGES)]
    for ci in range(c):
        for l in range(k):
            nz = H[ci, :, l] != 0
            offs = np.cumsum([0] + [int(nz[a:b].sum()) for a, b in ranges])
            for (a, b), off in zip(ranges, offs):
                hits = np.arange(a, b, dtype=np.int32)[nz[a:b]]
                rows[ci, l, off:off + len(hits)] = hits
            counts[ci, l] = offs[-1]
    return rows, counts


def _segments(D, d1, d2, vf, H, rows, counts):
    """B from the slot lists: for each slot its rows in list order, one
    term contrib_ij * H_il each, contrib = (clip(D_ij, d1_i, d2_i) -
    d1_i) * vf_i."""
    c, m, k = H.shape
    B = np.zeros((c, m, k), np.float32)
    for ci in range(c):
        for l in range(k):
            acc = np.zeros(m, np.float32)
            for i in rows[ci, l, :counts[ci, l]]:
                lo, hi = d1[ci, i], d2[ci, i]
                contrib = (np.minimum(np.maximum(D[ci, i], lo), hi) - lo) \
                    * vf[ci, i]
                acc = acc + contrib * H[ci, i, l]
            B[ci, :, l] = acc
    return B


def _inputs(c, m, seed):
    rng = np.random.default_rng(seed)
    D = rng.random((c, m, m), dtype=np.float32)
    d1 = rng.random((c, m), dtype=np.float32)
    d2 = (d1 + rng.random((c, m), dtype=np.float32)).astype(np.float32)
    vf = (rng.random((c, m)) < 0.8).astype(np.float32)
    return rng, D, d1, d2, vf


def _onehot(rng, c, m, k):
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, size=(c, m))]


def _multi(rng, c, m, k):
    """Two or more nonzeros a row of mixed sign and non-unit values, one
    zero row per client (of -0.0: a zero all the same)."""
    H = np.zeros((c, m, k), np.float32)
    for ci in range(c):
        for i in range(m):
            cols = rng.choice(k, size=min(k, int(rng.integers(2, 5))),
                              replace=False)
            H[ci, i, cols] = rng.normal(size=len(cols)).astype(np.float32)
        H[ci, int(rng.integers(m))] = -0.0
    return H


def _uneven(rng, c, m, k):
    """One slot holding 90 % of the rows, the rest on slot 1, every other
    slot empty."""
    idx = np.where(rng.random((c, m)) < 0.9, 0, min(1, k - 1))
    return np.eye(k, dtype=np.float32)[idx]


H_KINDS = {
    "onehot": _onehot,
    "multi": _multi,
    "dense": lambda rng, c, m, k: rng.normal(size=(c, m, k)).astype(
        np.float32),
    "uneven": _uneven,
}


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("c,m", [(1, 37), (3, 40), (8, 16), (2, 70)])
def test_walk_equals_plain_build_cost_and_a(c, m):
    """Kernel 2 and kernel 3's A: the walk's rows in increasing i, no
    mask, give the plain versions' bits."""
    rng, D, d1, d2, vf = _inputs(c, m, c * m)
    dn = rng.random((c, m), dtype=np.float32)
    dn[:, 0] = 1e30                 # the first pick's +BIG: a column sum
    want = ref.kmedoids_build_cost_ref(*_t(D, dn, vf))
    assert torch.equal(torch.as_tensor(_walk(D, dn, vf, True)), want)
    A_want, _ = ref.kmedoids_delta_sweep_ref(
        *_t(D, d1, d2, vf, _onehot(rng, c, m, 3)))
    assert torch.equal(torch.as_tensor(_walk(D, d1, vf, False)), A_want)


@pytest.mark.parametrize("kind", sorted(H_KINDS))
@pytest.mark.parametrize("c,m,k", [(1, 37, 1), (1, 37, 7), (3, 40, 13),
                                   (2, 33, 33), (1, 24, 24), (8, 16, 3)])
def test_slot_list_sums_equal_plain_delta_sweep(kind, c, m, k):
    """Kernel 3's B summed over the slot lists, and A by the walk: the
    bits of ``ref.kmedoids_delta_sweep_ref``."""
    rng, D, d1, d2, vf = _inputs(c, m, c + m + k)
    H = H_KINDS[kind](rng, c, m, k)
    rows, counts = slot_lists(H)
    A_want, B_want = ref.kmedoids_delta_sweep_ref(*_t(D, d1, d2, vf, H))
    assert torch.equal(torch.as_tensor(
        _segments(D, d1, d2, vf, H, rows, counts)), B_want)
    assert torch.equal(torch.as_tensor(_walk(D, d1, vf, False)), A_want)


@pytest.mark.parametrize("kind", sorted(H_KINDS))
@pytest.mark.parametrize("c,m,k", [(1, 37, 7), (2, 70, 5), (3, 1, 2),
                                   (1, 100, 100)])
def test_slot_lists_are_stable_and_complete(kind, c, m, k):
    """Each list holds its slot's nonzero rows in increasing i, its count
    is the column's nonzeros, and the counts add up to nnz(H)."""
    rng = np.random.default_rng(c * m * k)
    H = H_KINDS[kind](rng, c, m, k)
    if kind == "dense":
        H[rng.random(H.shape) < 0.3] = 0.0
    if kind == "multi":
        H[:, :, 0] = -0.0           # -0 is a zero: its slot stays empty
    rows, counts = slot_lists(H)
    assert int(counts.sum()) == int((H != 0).sum())
    for ci in range(c):
        for l in range(k):
            n = counts[ci, l]
            assert n == int((H[ci, :, l] != 0).sum())
            np.testing.assert_array_equal(rows[ci, l, :n],
                                          np.flatnonzero(H[ci, :, l]))
            assert (np.diff(rows[ci, l, :n]) > 0).all()
            assert (rows[ci, l, n:] == -1).all()
    if kind == "uneven" and k > 1:
        assert counts[:, 2:].sum() == 0
        assert (counts[:, 0] >= counts[:, 1]).all()


def _c_params(source, symbol):
    """The parameter list of the ``extern "C"`` entry point ``symbol`` of
    a ``csrc`` source."""
    text = (_build.CSRC / source).read_text()
    sig = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert sig, f"{symbol} not found in {source}"
    return [a.strip() for a in sig.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_entry_point_arity_matches_the_sources(name):
    """Every entry point takes what ``_build`` declares: pointers for its
    pointers, ints for its ints, floats for its floats, in order; a
    mismatch would corrupt a launch's arguments on the card."""
    import ctypes

    source, symbol, argtypes = _build.KERNELS[name]
    kinds = []
    for p in _c_params(source, symbol):
        kinds.append(ctypes.c_void_p if "*" in p else
                     ctypes.c_float if p.startswith("float") else
                     ctypes.c_int)
    assert kinds == list(argtypes), (source, symbol)


@pytest.mark.parametrize("src", ["build_cost.cu", "delta_sweep.cu",
                                 "kmedoids_from_feats.cu"])
def test_shipped_sources_hash_the_shared_column_walk(src):
    """Kernels 2, 3, 5 and 6 build the walk of one header: an edit to it,
    or to the copy helpers it includes, rebuilds all three sources."""
    files = _build._source_files(src)
    assert "column_walk.cuh" in files and "cp_async.cuh" in files
