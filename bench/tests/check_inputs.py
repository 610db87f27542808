"""The benchmark's frozen generators give the port's bytes today."""
import numpy as np
import torch

from bench.tests import common  # noqa: F401  (puts src on the path)
from bench.inputs import lm_stream, mnist_like, specs
from bench.inputs.lm_init import init_dense_lm


def test_pseudo_mnist_matches_port():
    from repro_torch.data import mnist_like_dataset
    for seed in (0, (1 << 40) + 3):
        got = mnist_like.mnist_like_dataset(25, seed=seed)
        want = mnist_like_dataset(25, seed=seed)
        for a, b in zip(got, want):
            for k in ("x", "y"):
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])


def test_capabilities_match_make_client_specs():
    from repro_torch.fed.simulator import make_client_specs
    sizes = list(range(10, 60))
    want = [s.c for s in make_client_specs(sizes, np.random.default_rng(7))]
    got = specs.sample_capabilities(len(sizes), np.random.default_rng(7))
    assert np.array_equal(np.asarray(want), got)


def test_token_stream_matches_port():
    from repro_torch.launch.train import synthetic_stream
    want = synthetic_stream(300, 4, 16, seed=9, device="cpu")
    got = lm_stream.synthetic_stream(300, 4, 16, seed=9)
    for _ in range(3):
        a, b = next(got), next(want)
        for k in ("tokens", "labels"):
            assert np.array_equal(a[k], b[k].numpy())


def test_dense_init_matches_port():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model
    cfg = dict(n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
               d_ff=48, vocab_size=100)
    mc = ModelConfig(arch_id="t", family="dense", **cfg)
    want = Model(mc).init(torch.Generator().manual_seed(5), "cpu")
    got = init_dense_lm(torch, cfg, 5, torch.device("cpu"))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_launcher_plan_matches_port():
    """The launcher's stragglers and budgets are the plan's (on seeds
    where no budget is floored, so that its own deadline check holds)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.train import train_fedcore_lm
    mc = ModelConfig(arch_id="t", family="dense", n_layers=1, d_model=16,
                     n_heads=2, n_kv_heads=1, d_ff=32, vocab_size=50)
    tried = 0
    for seed in range(200):
        caps = lm_stream.capabilities(4, seed)
        tau, budgets = lm_stream.plan(4, 8, 8, 30.0, seed)
        if not budgets or any(caps[s] * tau - 64 < 2 for s in budgets):
            continue
        out = train_fedcore_lm(mc, 1, 8, 4, 8, 8, 1e-3, 30.0, seed,
                               device="cpu")
        got = {s: len(v) for s, v in out["coresets"][0].items()}
        assert got == budgets
        tried += 1
        if tried == 3:
            break
    assert tried == 3
