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


@pytest.mark.parametrize("m,d", [(37, 60), (300, 1568), (129, 128)])
def test_pairwise_kernel_matches_plain(cuda, m, d):
    g = torch.Generator(device="cpu").manual_seed(m + d)
    x = torch.randn(m, d, generator=g).to(cuda)
    for squared in (True, False):
        got = ops.pairwise_l2(x, squared=squared, zero_diag=True)
        want = ops.pairwise_l2(x, squared=squared, zero_diag=True,
                               use_kernel=False)
        torch.cuda.synchronize()
        _same(got, want)
        assert bool((torch.diagonal(got) == 0).all())


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


@pytest.mark.parametrize("c,m,d", [(3, 37, 60), (16, 128, 144),
                                   (2, 65, 129)])
def test_pairwise_batched_kernel_matches_plain(cuda, c, m, d):
    g = torch.Generator(device="cpu").manual_seed(c * m + d)
    x = torch.randn(c, m, d, generator=g).to(cuda)
    for squared in (True, False):
        got = ops.pairwise_l2_batched(x, squared=squared, zero_diag=True)
        want = ops.pairwise_l2_batched(x, squared=squared, zero_diag=True,
                                       use_kernel=False)
        torch.cuda.synchronize()
        _same(got, want)
        assert bool((torch.diagonal(got, dim1=1, dim2=2) == 0).all())


@pytest.mark.parametrize("c,m,f", [(2, 40, 129), (3, 300, 64),
                                   (1, 256, 1568)])
def test_build_cost_from_feats_kernel_matches_plain(cuda, c, m, f):
    g = torch.Generator(device="cpu").manual_seed(c + m + f)
    x, vf = _masked_feats(g, c, m, f, cuda)
    dn = torch.rand(c, m, generator=g).to(cuda)
    got = ops.kmedoids_build_cost_from_feats(x, dn, vf)
    torch.cuda.synchronize()
    _same(got, ref.kmedoids_build_cost_from_feats_ref(x, dn, vf))
    assert bool((got[vf == 0] == 1e30).all())


@pytest.mark.parametrize("c,m,f,k", [(2, 40, 129, 7), (1, 300, 64, 1),
                                     (2, 256, 160, 130)])
def test_delta_sweep_from_feats_kernel_matches_plain(cuda, c, m, f, k):
    g = torch.Generator(device="cpu").manual_seed(c * k + m + f)
    x, vf = _masked_feats(g, c, m, f, cuda)
    d1 = torch.rand(c, m, generator=g).to(cuda)
    d2 = (d1.cpu() + torch.rand(c, m, generator=g)).to(cuda)
    idx = torch.randint(0, k, (c, m), generator=g)
    onehot = torch.nn.functional.one_hot(idx, k).float().to(cuda)
    A, B = ops.kmedoids_delta_sweep_from_feats(x, d1, d2, vf, onehot)
    torch.cuda.synchronize()
    A_ref, B_ref = ref.kmedoids_delta_sweep_from_feats_ref(x, d1, d2, vf,
                                                           onehot)
    _same(A, A_ref)
    _same(B, B_ref)
    assert bool((A[vf == 0] == 1e30).all())


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
