"""Card-only tests: each CUDA kernel against its plain version, and one
short FedCore run through the kernels.  They carry the ``cuda`` marker
and skip where ``torch.cuda.is_available()`` is false; on the card run
them with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
TF32 is off for the whole module: the medoid choice is pinned to fp32.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _same(got, want):
    """Bit for bit: each kernel sums in its plain version's order, with
    the same rounded products and adds."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())


def _tiles():
    """Every tile configuration of the pairwise kernel, and None (the
    wrapper's chooser)."""
    return list(range(len(ops.PAIRWISE_TILES))) + [None]


def _misaligned(x):
    """A contiguous copy of ``x`` whose storage starts 4 bytes past a
    16-byte boundary: the pairwise kernel's 4-byte copy path."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0
    return out


# ragged m around the tiles' 16, 32 and 64 rows; d = 60 and 129 end on a
# ragged k-chunk, 129 also has rows off 16-byte boundaries; (341, 1568)
# is the sync path's largest client, 2048 phase 2's headline
@pytest.mark.parametrize("m,d", [(37, 60), (300, 1568), (129, 128),
                                 (1, 32), (15, 129), (17, 60), (63, 1568),
                                 (65, 32), (129, 129), (341, 1568),
                                 (2048, 1568)])
def test_pairwise_kernel_matches_plain(cuda, m, d):
    """Kernel 1 at every tile configuration, squared or not, with and
    without a zero diagonal, in self mode (the triangle, mirrored) and with
    a second matrix y: bit for bit its plain version, and exactly
    symmetric in self mode."""
    g = torch.Generator(device="cpu").manual_seed(m + d)
    x = torch.randn(m, d, generator=g).to(cuda)
    y = torch.randn(m // 2 + 3, d, generator=g).to(cuda)
    for squared in (True, False):
        for zero_diag in (True, False):
            want = ops.pairwise_l2(x, squared=squared, zero_diag=zero_diag,
                                   use_kernel=False)
            want_y = ops.pairwise_l2(x, y, squared=squared,
                                     use_kernel=False)
            for tile in _tiles():
                got = ops._pairwise_l2_launch(x, None, squared, zero_diag,
                                              tile)
                got_y = ops._pairwise_l2_launch(x, y, squared, False, tile)
                torch.cuda.synchronize()
                _same(got, want)
                assert torch.equal(got, got.T)
                _same(got_y, want_y)
                if zero_diag:
                    assert bool((torch.diagonal(got) == 0).all())
    # storage off a 16-byte boundary: the same bits through 4-byte copies
    _same(ops.pairwise_l2(_misaligned(x), squared=True, zero_diag=True),
          ops.pairwise_l2(x, squared=True, zero_diag=True,
                          use_kernel=False))


@pytest.mark.parametrize("c,m", [(1, 37), (4, 300)])
def test_build_cost_kernel_matches_plain(cuda, c, m):
    g = torch.Generator(device="cpu").manual_seed(c * m)
    D = torch.rand(c, m, m, generator=g).to(cuda)
    dn = torch.rand(c, m, generator=g).to(cuda)
    vf = (torch.rand(c, m, generator=g) < 0.8).float().to(cuda)
    got = ops.kmedoids_build_cost(D, dn, vf)
    torch.cuda.synchronize()
    _same(got, ref.kmedoids_build_cost_ref(D, dn, vf))


@pytest.mark.parametrize("c,m,k", [(1, 37, 1), (2, 300, 7), (1, 200, 130)])
def test_delta_sweep_kernel_matches_plain(cuda, c, m, k):
    g = torch.Generator(device="cpu").manual_seed(c + m + k)
    D = torch.rand(c, m, m, generator=g).to(cuda)
    d1 = torch.rand(c, m, generator=g).to(cuda)
    d2 = (d1.cpu() + torch.rand(c, m, generator=g)).to(cuda)
    vf = (torch.rand(c, m, generator=g) < 0.8).float().to(cuda)
    idx = torch.randint(0, k, (c, m), generator=g)
    onehot = torch.nn.functional.one_hot(idx, k).float().to(cuda)
    A, B = ops.kmedoids_delta_sweep(D, d1, d2, vf, onehot)
    torch.cuda.synchronize()
    A_ref, B_ref = ref.kmedoids_delta_sweep_ref(D, d1, d2, vf, onehot)
    _same(A, A_ref)
    _same(B, B_ref)


# kernels 2 and 3 over a stored D: the column walk (kernel 2, kernel 3's
# A) and the slot-list sums (kernel 3's B); M around the walk's 8-column
# slices and 32-row stages, the sync path's M % 4 != 0 (rows of D off
# 16-byte boundaries), the fleets' C = 8 and 25 groups

@pytest.mark.parametrize("c", [1, 8, 25])
@pytest.mark.parametrize("m", [16, 37, 128, 341, 2048])
def test_build_cost_walk_matches_plain(cuda, c, m):
    """Kernel 2 bit for bit, also with D's storage 4 bytes off a 16-byte
    boundary (the walk's 4-byte copies), and one launch a call."""
    g = torch.Generator(device="cpu").manual_seed(c * 7 + m)
    D = torch.rand(c, m, m, generator=g).to(cuda)
    dn = torch.rand(c, m, generator=g)
    dn[:, 0] = 1e30
    dn = dn.to(cuda)
    vf = (torch.rand(c, m, generator=g) < 0.9).float().to(cuda)
    want = ref.kmedoids_build_cost_ref(D, dn, vf)
    before = ops.LAUNCHES["build_cost"]
    got = ops.kmedoids_build_cost(D, dn, vf)
    torch.cuda.synchronize()
    _same(got, want)
    assert ops.LAUNCHES["build_cost"] == before + 1
    _same(ops.kmedoids_build_cost(_misaligned(D), dn, vf), want)


def _sweep_d(g, c, m, dev):
    D = torch.rand(c, m, m, generator=g)
    d1 = torch.rand(c, m, generator=g)
    d2 = d1 + torch.rand(c, m, generator=g)
    vf = (torch.rand(c, m, generator=g) < 0.9).float()
    return [t.to(dev) for t in (D, d1, d2, vf)]


def _check_sweep(D, d1, d2, vf, H):
    A_ref, B_ref = ref.kmedoids_delta_sweep_ref(D, d1, d2, vf, H)
    before = ops.LAUNCHES["delta_sweep"]
    A, B = ops.kmedoids_delta_sweep(D, d1, d2, vf, H)
    torch.cuda.synchronize()
    _same(A, A_ref)
    _same(B, B_ref)
    assert ops.LAUNCHES["delta_sweep"] == before + 1


@pytest.mark.parametrize("c,m", [(1, 341), (2, 200), (1, 2048)])
@pytest.mark.parametrize("k", [1, 7, 64, 130, None])
def test_delta_sweep_onehot_matches_plain(cuda, c, m, k):
    """Kernel 3 on a one-hot H at K = 1, 7, 64, 130 and M, bit for bit,
    also with D and H off 16-byte boundaries."""
    k = m if k is None else k
    g = torch.Generator(device="cpu").manual_seed(c + m + k)
    D, d1, d2, vf = _sweep_d(g, c, m, cuda)
    idx = torch.randint(0, k, (c, m), generator=g)
    H = torch.nn.functional.one_hot(idx, k).float().to(cuda)
    _check_sweep(D, d1, d2, vf, H)
    if m <= 341:
        A_ref, B_ref = ref.kmedoids_delta_sweep_ref(D, d1, d2, vf, H)
        A, B = ops.kmedoids_delta_sweep(_misaligned(D), d1, d2, vf,
                                        _misaligned(H))
        torch.cuda.synchronize()
        _same(A, A_ref)
        _same(B, B_ref)


def _general_h(g, c, m, k, kind):
    if kind == "dense":
        return torch.randn(c, m, k, generator=g)
    # two to four nonzeros a row, of mixed sign and not 1, and a zero row
    # of -0.0 in each client
    H = torch.zeros(c, m, k)
    for ci in range(c):
        for i in range(m):
            n = int(torch.randint(2, 5, (1,), generator=g))
            cols = torch.randperm(k, generator=g)[:n]
            H[ci, i, cols] = torch.randn(len(cols), generator=g)
        H[ci, int(torch.randint(0, m, (1,), generator=g))] = -0.0
    return H


@pytest.mark.parametrize("kind", ["multi", "dense"])
@pytest.mark.parametrize("c,m,k", [(1, 37, 7), (3, 64, 13), (2, 64, 64),
                                   (1, 33, 40)])
def test_delta_sweep_any_h_matches_plain(cuda, kind, c, m, k):
    """Kernel 3 on an H that is not one-hot: several nonzeros a row of
    mixed sign and non-unit values, a zero row, and a dense random H
    (every slot M rows long): the same bits as the dense plain product."""
    g = torch.Generator(device="cpu").manual_seed(c * m + k)
    D, d1, d2, vf = _sweep_d(g, c, m, cuda)
    _check_sweep(D, d1, d2, vf, _general_h(g, c, m, k, kind).to(cuda))


@pytest.mark.parametrize("c,m,k", [(1, 2048, 7), (1, 2048, 1),
                                   (25, 128, 64), (1, 341, 40)])
def test_delta_sweep_uneven_slots_match_plain(cuda, c, m, k):
    """One slot holding 90 % of the rows (a chain of them), one more
    holding the rest, every other slot empty (B = +0 there)."""
    g = torch.Generator(device="cpu").manual_seed(m + k)
    D, d1, d2, vf = _sweep_d(g, c, m, cuda)
    idx = torch.where(torch.rand(c, m, generator=g) < 0.9, 0, min(1, k - 1))
    H = torch.nn.functional.one_hot(idx, k).float().to(cuda)
    _check_sweep(D, d1, d2, vf, H)
    _, B = ops.kmedoids_delta_sweep(D, d1, d2, vf, H)
    if k > 2:
        assert bool((B[..., 2:] == 0).all())
        assert not bool(torch.signbit(B[..., 2:]).any())


def test_delta_sweep_without_slots_still_sums_a(cuda):
    """K = 0: no slot lists and no B to sum, but A is still the walk's."""
    g = torch.Generator(device="cpu").manual_seed(0)
    D, d1, d2, vf = _sweep_d(g, 2, 37, cuda)
    _check_sweep(D, d1, d2, vf, torch.zeros(2, 37, 0, device=cuda))


def test_kmedoids_client_is_its_own_call(cuda):
    """The loop-vs-batched invariant for kernels 2 and 3: client i of a
    (25, 128) stack gets the bits of its own C = 1 call."""
    g = torch.Generator(device="cpu").manual_seed(25)
    D, d1, d2, vf = _sweep_d(g, 25, 128, cuda)
    idx = torch.randint(0, 64, (25, 128), generator=g)
    H = torch.nn.functional.one_hot(idx, 64).float().to(cuda)
    cost = ops.kmedoids_build_cost(D, d1, vf)
    A, B = ops.kmedoids_delta_sweep(D, d1, d2, vf, H)
    for i in range(25):
        one = [t[i:i + 1].contiguous() for t in (D, d1, d2, vf, H)]
        c1 = ops.kmedoids_build_cost(one[0], one[1], one[3])
        A1, B1 = ops.kmedoids_delta_sweep(*one)
        torch.cuda.synchronize()
        _same(cost[i:i + 1], c1)
        _same(A[i:i + 1], A1)
        _same(B[i:i + 1], B1)


def test_short_fedcore_run_goes_through_the_kernels(cuda):
    from repro_torch.data import mnist_like_dataset
    from repro_torch.fed import (FedCore, FLConfig, LocalTrainer,
                                 make_client_specs, run_federated)
    from repro_torch.models import SmallCNN

    clients = mnist_like_dataset(n_clients=12, seed=0)
    specs = make_client_specs([len(d["y"]) for d in clients],
                              np.random.default_rng(0))
    model = SmallCNN()
    cfg = FLConfig(rounds=2, clients_per_round=6, epochs=3, batch_size=8,
                   lr=0.03, straggler_pct=50.0)
    ops.reset_launch_counts()
    out = run_federated(model, clients, specs,
                        FedCore(LocalTrainer(model, cfg.lr, cfg.batch_size)),
                        cfg)
    assert sum(h.n_coreset for h in out["history"]) > 0
    for name in ("pairwise_l2", "build_cost", "delta_sweep"):
        assert ops.LAUNCHES[name] > 0, ops.LAUNCHES
    assert all(bool(torch.isfinite(v).all()) for v in out["params"].values())
    assert all(v.device.type == "cuda" for v in out["params"].values())


# ---------------------------------------------------------------------------
# the fleet engine's kernels (batched pairwise, distance-free BUILD and
# Δ-sweep) and a short fleet run through them
# ---------------------------------------------------------------------------

def _masked_feats(g, c, m, f, dev):
    x = torch.randn(c, m, f, generator=g)
    vf = (torch.rand(c, m, generator=g) < 0.8).float()
    vf[:, :2] = 1.0
    return (x * vf[..., None]).to(dev), vf.to(dev)


# the fleets' groups below the cutover: (25, 128, 1568) and (8, 16, 1568)
# of the CNN fleet, (6, 32, 32) and (11, 128, 32) of the char-LM fleets;
# ragged M, d = 129 (rows off 16-byte boundaries) and d = 60
@pytest.mark.parametrize("c,m,d", [(3, 37, 60), (16, 128, 144),
                                   (2, 65, 129), (25, 128, 1568),
                                   (8, 16, 1568), (6, 32, 32),
                                   (11, 128, 32), (2, 1, 32), (4, 15, 129),
                                   (3, 17, 60), (2, 63, 32), (2, 65, 1568),
                                   (1, 341, 129)])
def test_pairwise_batched_kernel_matches_plain(cuda, c, m, d):
    """Kernel 4 at every tile configuration, squared or not, with and
    without a zero diagonal: bit for bit its plain version, and each
    client's matrix exactly symmetric."""
    g = torch.Generator(device="cpu").manual_seed(c * m + d)
    x = torch.randn(c, m, d, generator=g).to(cuda)
    for squared in (True, False):
        for zero_diag in (True, False):
            want = ops.pairwise_l2_batched(x, squared=squared,
                                           zero_diag=zero_diag,
                                           use_kernel=False)
            for tile in _tiles():
                got = ops._pairwise_l2_batched_launch(x, squared,
                                                      zero_diag, tile)
                torch.cuda.synchronize()
                _same(got, want)
                assert torch.equal(got, got.transpose(1, 2))
                if zero_diag:
                    assert bool((torch.diagonal(got, dim1=1,
                                                dim2=2) == 0).all())


def test_pairwise_batched_client_is_its_own_matrix(cuda):
    """The loop-vs-batched engine invariant: client i of a C = 25 kernel-4
    stack (the CNN fleet's group below the cutover) equals kernel 4 at
    C = 1 on that client and kernel 1 on it, bit for bit, whatever tiles
    the three calls get."""
    g = torch.Generator(device="cpu").manual_seed(25)
    x = torch.randn(25, 128, 1568, generator=g).to(cuda)
    stack = ops.pairwise_l2_batched(x, zero_diag=True)
    for i in range(x.shape[0]):
        one = ops.pairwise_l2_batched(x[i:i + 1].contiguous(),
                                      zero_diag=True)
        single = ops.pairwise_l2(x[i].contiguous(), zero_diag=True)
        torch.cuda.synchronize()
        _same(stack[i], one[0])
        _same(stack[i], single)


# ragged M around the 32-row stages and tiles; F = 129, 60 and 33 take
# 4-byte copies (rows off 16-byte boundaries); (22, 256, 1568) is the CNN
# fleet's main distance-free group, (1, 2048, 32) the char-LM fleets'
# largest
@pytest.mark.parametrize("c,m,f", [(2, 40, 129), (3, 300, 64),
                                   (1, 256, 1568), (22, 256, 1568),
                                   (1, 2048, 32), (2, 1, 16), (3, 33, 60),
                                   (2, 65, 33), (1, 514, 20)])
def test_build_cost_from_feats_kernel_matches_plain(cuda, c, m, f):
    g = torch.Generator(device="cpu").manual_seed(c + m + f)
    x, vf = _masked_feats(g, c, m, f, cuda)
    dn = torch.rand(c, m, generator=g).to(cuda)
    got = ops.kmedoids_build_cost_from_feats(x, dn, vf)
    torch.cuda.synchronize()
    _same(got, ref.kmedoids_build_cost_from_feats_ref(x, dn, vf))
    assert bool((got[vf == 0] == 1e30).all())


def _sweep_inputs(g, c, m, f, k, dev):
    x, vf = _masked_feats(g, c, m, f, dev)
    d1 = torch.rand(c, m, generator=g)
    d2 = (d1 + torch.rand(c, m, generator=g)).to(dev)
    idx = torch.randint(0, k, (c, m), generator=g)
    onehot = torch.nn.functional.one_hot(idx, k).float().to(dev)
    return x, d1.to(dev), d2, vf, onehot


# K = 1, K > 64 (130) and ragged K (7, 33, 65: rows of H off 16-byte
# boundaries); ragged M and F as above
@pytest.mark.parametrize("c,m,f,k", [(2, 40, 129, 7), (1, 300, 64, 1),
                                     (2, 256, 160, 130), (22, 256, 64, 64),
                                     (1, 2048, 32, 1), (3, 33, 60, 33),
                                     (2, 65, 33, 65), (1, 97, 16, 128),
                                     (2, 1, 8, 1)])
def test_delta_sweep_from_feats_kernel_matches_plain(cuda, c, m, f, k):
    g = torch.Generator(device="cpu").manual_seed(c * k + m + f)
    x, d1, d2, vf, onehot = _sweep_inputs(g, c, m, f, k, cuda)
    A, B = ops.kmedoids_delta_sweep_from_feats(x, d1, d2, vf, onehot)
    torch.cuda.synchronize()
    A_ref, B_ref = ref.kmedoids_delta_sweep_from_feats_ref(x, d1, d2, vf,
                                                           onehot)
    _same(A, A_ref)
    _same(B, B_ref)
    assert bool((A[vf == 0] == 1e30).all())


def test_from_feats_kernels_at_misaligned_storage(cuda):
    """Storage 4 bytes off a 16-byte boundary (features, H): the 4-byte
    copy paths give the same bits."""
    g = torch.Generator(device="cpu").manual_seed(7)
    x, d1, d2, vf, onehot = _sweep_inputs(g, 2, 200, 64, 12, cuda)
    want = ref.kmedoids_build_cost_from_feats_ref(x, d1, vf)
    _same(ops.kmedoids_build_cost_from_feats(_misaligned(x), d1, vf), want)
    A, B = ops.kmedoids_delta_sweep_from_feats(_misaligned(x), d1, d2, vf,
                                               _misaligned(onehot))
    A_ref, B_ref = ref.kmedoids_delta_sweep_from_feats_ref(x, d1, d2, vf,
                                                           onehot)
    torch.cuda.synchronize()
    _same(A, A_ref)
    _same(B, B_ref)


@pytest.mark.parametrize("c,m,f,k", [(5, 100, 64, 7), (2, 130, 33, 65)])
def test_from_feats_small_cap_runs_chunks_and_bands(cuda, c, m, f, k):
    """A workspace cap forced small: chunks of half the clients, then
    bands of 37 rows and of one row (each band continuing the sums of
    the last); every cap gives the bits of the plain version and counts
    one launch a call."""
    g = torch.Generator(device="cpu").manual_seed(c + m + f + k)
    x, d1, d2, vf, onehot = _sweep_inputs(g, c, m, f, k, cuda)
    want = ref.kmedoids_build_cost_from_feats_ref(x, d1, vf)
    A_ref, B_ref = ref.kmedoids_delta_sweep_from_feats_ref(x, d1, d2, vf,
                                                           onehot)
    for cap in (4 * m * m * (c // 2), 4 * m * 37, 4 * m):
        plan = ops.from_feats_plan(c, m, cap)
        assert len(plan) > 1
        before = dict(ops.LAUNCHES)
        cost = ops._build_cost_from_feats_launch(x, d1, vf, cap)
        A, B = ops._delta_sweep_from_feats_launch(x, d1, d2, vf, onehot,
                                                  cap)
        torch.cuda.synchronize()
        _same(cost, want)
        _same(A, A_ref)
        _same(B, B_ref)
        for name in ("build_cost_from_feats", "delta_sweep_from_feats"):
            assert ops.LAUNCHES[name] == before[name] + 1


def test_from_feats_client_is_its_own_call(cuda):
    """The loop-vs-batched engine invariant: client i of the CNN fleet's
    (22, 256, 1568) group gets the bits of its own C = 1 call, in both
    kernels."""
    g = torch.Generator(device="cpu").manual_seed(22)
    x, d1, d2, vf, onehot = _sweep_inputs(g, 22, 256, 1568, 64, cuda)
    cost = ops.kmedoids_build_cost_from_feats(x, d1, vf)
    A, B = ops.kmedoids_delta_sweep_from_feats(x, d1, d2, vf, onehot)
    for i in range(x.shape[0]):
        one = slice(i, i + 1)
        args = [t[one].contiguous() for t in (x, d1, d2, vf, onehot)]
        c1 = ops.kmedoids_build_cost_from_feats(args[0], args[1], args[3])
        A1, B1 = ops.kmedoids_delta_sweep_from_feats(*args)
        torch.cuda.synchronize()
        _same(cost[one], c1)
        _same(A[one], A1)
        _same(B[one], B1)


@pytest.mark.parametrize("cap", [None, 4 * 2048 * 100])
def test_from_feats_peak_memory_within_the_cap(cuda, cap):
    """A call's peak allocation above its inputs (the bytes it asks the
    caching allocator for, ``torch.cuda.memory_stats``' requested bytes,
    so that no block rounding of the allocator counts): the outputs, the
    squared norms and the larger of the distance workspace (at most the
    cap) and the norms' one temporary x*x, which is freed before the
    workspace is taken; never the (C, M, M) stack beyond the cap."""
    c, m, f, k = 1, 2048, 256, 130
    cap = ops.FROM_FEATS_WORKSPACE_BYTES if cap is None else cap
    g = torch.Generator(device="cpu").manual_seed(3)
    x, d1, d2, vf, onehot = _sweep_inputs(g, c, m, f, k, cuda)
    ws = min(cap, 4 * c * m * m)
    norms, temp = 4 * c * m, 4 * c * m * f
    for outputs, call in (
            (4 * c * m,
             lambda: ops._build_cost_from_feats_launch(x, d1, vf, cap)),
            (4 * c * m + 4 * c * m * k,
             lambda: ops._delta_sweep_from_feats_launch(x, d1, d2, vf,
                                                        onehot, cap))):
        call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        stats = torch.cuda.memory_stats(cuda)
        base = stats["requested_bytes.all.current"]
        out = call()
        torch.cuda.synchronize()
        peak = (torch.cuda.memory_stats(cuda)["requested_bytes.all.peak"]
                - base)
        assert peak <= norms + outputs + max(ws, temp), \
            (peak, norms, outputs, ws, temp)
        del out


def test_short_fleet_run_goes_through_the_fleet_kernels(cuda):
    """Two rounds of the batched fleet engine on the CNN workload, with
    groups on both sides of the M = 256 cutover."""
    from repro_torch.fed.fleet import FleetConfig, get_workload, run_fleet
    from repro_torch.fed.simulator import make_client_specs

    wl = get_workload("cnn")
    clients = wl.make_clients(n_clients=24, seed=0, mean_samples=120.0,
                              std_samples=90.0)
    sizes = [len(d["y"]) for d in clients]
    specs = make_client_specs(sizes, np.random.default_rng(0))
    cfg = FleetConfig(epochs=2, batch_size=8, lr=0.05)
    ops.reset_launch_counts()
    out = run_fleet(wl, clients, specs, cfg, 2, straggler_pct=50.0)
    assert sum(h.n_coreset for h in out["history"]) > 0
    for name in ("pairwise_l2_batched", "build_cost_from_feats",
                 "delta_sweep_from_feats", "build_cost", "delta_sweep"):
        assert ops.LAUNCHES[name] > 0, ops.LAUNCHES
    assert all(bool(torch.isfinite(v).all()) for v in out["params"].values())
    assert all(v.device.type == "cuda" for v in out["params"].values())


# ---------------------------------------------------------------------------
# kernel 7: flash attention, its gradient under vmap, and a translm fleet
# ---------------------------------------------------------------------------

def _qkv(b, hq, hk, s, hd, dtype, dev):
    g = torch.Generator(device="cpu").manual_seed(b * s + hd)
    return tuple(torch.randn(b, h, s, hd, generator=g).to(dev, dtype)
                 for h in (hq, hk, hk))


def _bf16_rule(got, q, k, v, causal, window):
    """The bf16 kernel's check (its wgmma sums run in the hardware's
    order, which no plain version repeats): (i) within rtol = atol = 2e-2
    of the plain version; (ii) max and mean absolute error against the
    float64 oracle each at most 2x SDPA's on the same bf16 inputs."""
    import torch.nn.functional as F

    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), plain.float(), rtol=2e-2,
                               atol=2e-2)
    oracle = ref.flash_attention_f64(q, k, v, causal=causal, window=window)
    mask = ref.attention_mask(q.shape[2], causal, window, q.device)
    sdpa = F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask if window else None,
        is_causal=causal and not window, enable_gqa=q.shape[1] != k.shape[1])
    e_k, e_s = (got.double() - oracle).abs(), (sdpa.double() - oracle).abs()
    assert float(e_k.max()) <= 2 * float(e_s.max()), \
        (float(e_k.max()), float(e_s.max()))
    assert float(e_k.mean()) <= 2 * float(e_s.mean()), \
        (float(e_k.mean()), float(e_s.mean()))


@pytest.mark.parametrize("b,hq,hk,s,hd,window,dtype", [
    (2, 4, 2, 128, 64, None, torch.float32),
    (2, 8, 1, 128, 64, None, torch.float32),
    (1, 4, 2, 128, 64, 48, torch.float32),
    (1, 2, 2, 64, 128, None, torch.float32),
    (1, 2, 2, 128, 64, None, torch.bfloat16),
    (3, 2, 2, 40, 16, None, torch.float32),
    (2, 4, 2, 100, 32, 16, torch.bfloat16)])
def test_flash_attention_kernel_matches_plain(cuda, b, hq, hk, s, hd,
                                              window, dtype):
    """fp32: bit for bit; bf16: the tensor-core path's rule."""
    q, k, v = _qkv(b, hq, hk, s, hd, dtype, cuda)
    for causal in (True, False):
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == 1
        if dtype == torch.bfloat16:
            _bf16_rule(got, q, k, v, causal, window)
        else:
            _same(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window))


@pytest.mark.parametrize("hd", [16, 64, 100, 128])
@pytest.mark.parametrize("b,hq,hk,s,window,causal", [
    (1, 4, 2, 256, None, True), (2, 2, 1, 192, 16, True),
    (1, 2, 2, 40, None, True), (1, 4, 4, 130, 128, False),
    (2, 2, 2, 77, None, False)])
def test_bf16_flash_attention_against_the_oracle(cuda, b, hq, hk, s, window,
                                                 causal, hd):
    """The tensor-core path at head dims 16, 64, 100 (padded) and 128,
    causal, windowed, full, GQA and ragged S."""
    q, k, v = _qkv(b, hq, hk, s, hd, torch.bfloat16, cuda)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _bf16_rule(got, q, k, v, causal, window)


@pytest.mark.parametrize("s", [1, 16, 24, 32])
@pytest.mark.parametrize("b,hq,hk,hd,window", [
    (672, 2, 2, 16, None), (5, 4, 2, 32, 7), (3, 3, 1, 40, None)])
def test_packed_fp32_flash_attention_is_bit_for_bit(cuda, b, hq, hk, hd,
                                                    window, s):
    """S <= 32: a block packs 64 / S_pad sequences; each row keeps its
    plain arithmetic and order (B * Hq not a multiple of the pack too)."""
    q, k, v = _qkv(b, hq, hk, s, hd, torch.float32, cuda)
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        _same(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window))


def test_bf16_call_takes_the_tensor_core_kernel(cuda):
    """One launch per call; the bf16 call runs the wgmma kernel, the fp32
    call the SIMT one (the kernel names in the profile)."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _qkv(2, 4, 2, 128, 64, dtype, cuda)
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops.flash_attention(q, k, v)
            torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == 1
        names[dtype] = [e.key for e in prof.key_averages()
                        if "flash_attention" in e.key]
    assert len(names[torch.bfloat16]) == 1, names
    assert "wgmma" in names[torch.bfloat16][0], names
    assert names[torch.float32] and \
        all("wgmma" not in n for n in names[torch.float32]), names


def test_vmap_of_grad_launches_the_kernel_once_per_step(cuda):
    """The fleet engine's vmapped SGD step: one launch for all clients,
    and each client's gradient equal to its own through the plain
    forward (the backward is the same tensor ops)."""
    from torch.func import grad, vmap

    g = torch.Generator(device="cpu").manual_seed(3)
    q = torch.randn(5, 8, 2, 16, 16, generator=g).to(cuda)

    def loss(q, use_kernel):
        return torch.sum(ops.flash_attention(q, q, q, use_kernel=use_kernel)
                         ** 2)

    ops.reset_launch_counts()
    got = vmap(grad(loss), in_dims=(0, None))(q, None)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    want = vmap(grad(loss), in_dims=(0, None))(q, False)
    _same(got, want)


def test_short_translm_fleet_goes_through_the_attention_kernel(cuda):
    from repro_torch.fed.fleet import FleetConfig, get_workload, run_fleet
    from repro_torch.fed.simulator import make_client_specs

    wl = get_workload("translm")
    clients = wl.make_clients(n_clients=16, seed=0, mean_samples=60.0,
                              std_samples=40.0)
    specs = make_client_specs([len(d["y"]) for d in clients],
                              np.random.default_rng(0))
    ops.reset_launch_counts()
    out = run_fleet(wl, clients, specs, FleetConfig(epochs=2, batch_size=8,
                                                    lr=0.05), 1,
                    straggler_pct=50.0)
    assert out["history"][0].n_coreset > 0
    assert ops.LAUNCHES["flash_attention"] > 0, ops.LAUNCHES
    assert all(bool(torch.isfinite(v).all()) for v in out["params"].values())
    assert all(v.device.type == "cuda" for v in out["params"].values())


# ---------------------------------------------------------------------------
# kernel 8: RMSNorm, its gradient under vmap, and an xlstm fleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,m,d,dtype", [
    (1, 37, 96, torch.float32), (1, 256, 512, torch.bfloat16),
    (1, 1, 8, torch.float32), (3, 5, 33, torch.float32),
    (84, 128, 32, torch.float32), (2, 7, 4097, torch.bfloat16),
    (4, 3, 1, torch.float32), (5, 11, 768, torch.bfloat16)])
def test_rmsnorm_kernel_matches_plain(cuda, g, m, d, dtype):
    """Ragged m, d not a multiple of 32, bf16 and a grouped scale: bit for
    bit."""
    gen = torch.Generator(device="cpu").manual_seed(g * m + d)
    x = (3.0 * torch.randn(g, m, d, generator=gen)).to(cuda, dtype)
    scale = torch.randn(g, d, generator=gen).to(cuda)
    ops.reset_launch_counts()
    got = ops._RMSNorm.apply(x, scale, 1e-5, True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == 1
    _same(got, ref.rmsnorm_ref(x, scale, 1e-5))
    flat = ops.rmsnorm(x[0], scale[0])
    torch.cuda.synchronize()
    _same(flat, ops.rmsnorm(x[0], scale[0], use_kernel=False))


@pytest.mark.parametrize("d,dtype", [
    (1, torch.float32), (37, torch.float32), (97, torch.bfloat16),
    (1025, torch.float32), (4097, torch.bfloat16), (32, torch.float32),
    (2049, torch.bfloat16), (64, torch.bfloat16)])
def test_rmsnorm_kernel_bit_for_bit_at_odd_d_and_offsets(cuda, d, dtype):
    """Every load shape of the kernel (short rows, rows in registers,
    streamed rows, ragged tails) at an aligned and a misaligned start: a
    contiguous view one element into its storage takes the scalar
    path."""
    gen = torch.Generator(device="cpu").manual_seed(d)
    g, m = 3, 9
    buf = (3.0 * torch.randn(g * m * d + 1, generator=gen)).to(cuda, dtype)
    scale = torch.randn(g, d, generator=gen).to(cuda)
    for x in (buf[:-1].view(g, m, d), buf[1:].view(g, m, d)):
        assert x.is_contiguous()
        got = ops._RMSNorm.apply(x, scale, 1e-5, True)
        torch.cuda.synchronize()
        _same(got, ref.rmsnorm_ref(x, scale, 1e-5))
    # a misaligned scale row too
    sbuf = torch.randn(g * d + 1, generator=gen).to(cuda)[1:].view(g, d)
    _same(ops._RMSNorm.apply(x, sbuf, 1e-5, True),
          ref.rmsnorm_ref(x, sbuf, 1e-5))


def test_rmsnorm_vmap_keeps_one_scale_per_group(cuda):
    """Under vmap each client's rows are normalised with its own scale,
    bit for bit as the plain version does group by group, in one
    launch."""
    from torch.func import vmap

    gen = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(84, 8, 16, 32, generator=gen).to(cuda)
    scale = torch.randn(84, 32, generator=gen).to(cuda)
    ops.reset_launch_counts()
    got = vmap(lambda xc, sc: ops.rmsnorm(xc, sc))(x, scale)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == 1
    want = torch.stack([ref.rmsnorm_ref(x[c].reshape(1, -1, 32),
                                        scale[c:c + 1], 1e-5)
                        .reshape(x.shape[1:]) for c in range(84)])
    _same(got, want)


def test_rmsnorm_vmap_of_grad_launches_once_per_step(cuda):
    """Each vmapped client keeps its own scale in the one launch; its
    gradient equals the plain forward's (the backward is the same ops)."""
    from torch.func import grad, vmap

    gen = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(6, 8, 16, 32, generator=gen).to(cuda)
    scale = torch.randn(6, 32, generator=gen).to(cuda)

    def loss(x, scale, use_kernel):
        return torch.sum(ops.rmsnorm(x, scale, use_kernel=use_kernel) ** 2
                         * torch.arange(32, device=x.device))

    for in_dims in ((0, 0), (0, None), (None, 0)):
        args = (x if in_dims[0] == 0 else x[0],
                scale if in_dims[1] == 0 else scale[0])
        ops.reset_launch_counts()
        got = vmap(grad(loss, argnums=(0, 1)),
                   in_dims=in_dims + (None,))(*args, None)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["rmsnorm"] == 1
        want = vmap(grad(loss, argnums=(0, 1)),
                    in_dims=in_dims + (None,))(*args, False)
        for a, b in zip(got, want):
            _same(a, b)


def test_short_xlstm_fleet_goes_through_the_rmsnorm_kernel(cuda):
    from repro_torch.fed.fleet import FleetConfig, get_workload, run_fleet
    from repro_torch.fed.simulator import make_client_specs

    wl = get_workload("xlstm")
    clients = wl.make_clients(n_clients=16, seed=0, mean_samples=60.0,
                              std_samples=40.0)
    specs = make_client_specs([len(d["y"]) for d in clients],
                              np.random.default_rng(0))
    ops.reset_launch_counts()
    out = run_fleet(wl, clients, specs, FleetConfig(epochs=2, batch_size=8,
                                                    lr=0.05), 1,
                    straggler_pct=50.0)
    assert out["history"][0].n_coreset > 0
    assert ops.LAUNCHES["rmsnorm"] > 0, ops.LAUNCHES
    assert all(bool(torch.isfinite(v).all()) for v in out["params"].values())
    assert all(v.device.type == "cuda" for v in out["params"].values())
