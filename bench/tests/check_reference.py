"""The reference's plain pieces at tiny sizes, against the port's plain
(CPU) versions where the port has them."""
import numpy as np
import pytest
import torch

from bench.tests import common  # noqa: F401
from bench.reference import kmedoids, llama, smallcnn


def test_kmedoids_matches_the_float64_oracle():
    from repro_torch.core.kmedoids import kmedoids_numpy
    rng = np.random.default_rng(3)
    for m, k in ((12, 1), (20, 4), (40, 7)):
        x = rng.normal(size=(m, 5))
        D = kmedoids.distances(torch.as_tensor(x)[None])
        got = kmedoids.solve(D, torch.ones(1, m, dtype=torch.bool), k, 100)
        want = kmedoids_numpy(D[0].numpy(), k, max_sweeps=100)
        assert sorted(got.medoids[0].tolist()) == sorted(
            want.medoids.tolist())
        assert float(got.objective[0]) == pytest.approx(
            float(want.objective), rel=1e-6)
        assert int(got.weights.sum()) == m


def test_kmedoids_padded_lanes_solve_their_own_instance():
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(2, 16, 3)))
    valid = torch.ones(2, 16, dtype=torch.bool)
    valid[1, 10:] = False
    D = kmedoids.distances(x * valid[..., None])
    both = kmedoids.solve(D, valid, 3, 50)
    alone = kmedoids.solve(kmedoids.distances(x[1:, :10]),
                           torch.ones(1, 10, dtype=torch.bool), 3, 50)
    assert sorted(both.medoids[1].tolist()) == sorted(
        alone.medoids[0].tolist())
    assert torch.equal(both.weights[1].sort().values,
                       alone.weights[0].sort().values)


def test_smallcnn_matches_the_port():
    from repro_torch.models import SmallCNN
    model = SmallCNN(image_size=28, channels=(16, 32))
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(5, 28, 28, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([0, 3, 3, 9, 1], dtype=torch.int32)
    torch.testing.assert_close(smallcnn.logits(p, x), model.logits(p, x))
    torch.testing.assert_close(smallcnn.grad_features(p, x, y),
                               model.grad_features(p, {"x": x, "y": y}))
    w = torch.tensor([1.0, 0.0, 2.0, 1.0, 1.0])
    torch.testing.assert_close(
        smallcnn.weighted_loss(p, x, y, w),
        model.loss(p, {"x": x, "y": y, "weights": w})[0])


def test_llama_matches_the_port():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model
    cfg = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
               d_ff=48, vocab_size=100, norm_eps=1e-5, rope_theta=10000.0)
    mc = ModelConfig(arch_id="t", family="dense", **cfg)
    model = Model(mc)
    p = model.init(torch.Generator().manual_seed(2), "cpu")
    tok = torch.randint(0, 100, (3, 12),
                        generator=torch.Generator().manual_seed(3))
    lab = torch.roll(tok, -1, 1)
    want, _, _ = model.forward(p, {"tokens": tok}, impl="naive")
    got, _ = llama.forward(p, cfg, tok)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    w = torch.tensor([1.0, 2.0, 0.5])
    torch.testing.assert_close(
        llama.loss(p, cfg, tok, lab, w),
        model.loss(p, {"tokens": tok, "labels": lab, "weights": w},
                   impl="naive")[0], rtol=1e-5, atol=1e-6)
