"""The operation and byte counts against hand-worked values at the
published shapes (PERF.md's table of kernels)."""
import pytest

from bench.tests import common  # noqa: F401
from bench.reference import llama, smallcnn
from bench.roofline import counts
from bench.roofline.peaks import bound_s


def ms(nbytes_nops):
    return 1e3 * bound_s(*nbytes_nops)


@pytest.mark.parametrize("case,want_ms", [
    # kernel 1 at m = 2048, d = 1568: the triangle's operations
    (counts.pairwise_l2(2048, 1568), 0.0984),
    # kernel 4 at C = 16, M = 128, D = 1568
    (counts.pairwise_l2_batched(16, 128, 1568), 0.0063),
    # kernel 2 at C = 1, M = 2048: bytes
    (counts.build_cost(1, 2048), 0.0050),
    # kernel 3 at M = 2048, K = 700, one-hot: bytes
    (counts.delta_sweep(1, 2048, 700, 2048), 0.0084),
    # kernels 5 and 6 at C = 1, M = 2048, F = 1568 (K = 130, one-hot)
    (counts.build_cost_from_feats(1, 2048, 1568), 0.0986),
    (counts.delta_sweep_from_feats(1, 2048, 1568, 130, 2048), 0.0991),
    # kernel 7 at yi-9b's prefill (1, 32, 4, 4096, 128), causal fp32
    (counts.flash_attention_gqa(1, 32, 4, 4096, 128), 2.0518),
    # kernel 8 at (4096, 4096) fp32: bytes
    (counts.rmsnorm(4096, 4096), 0.0401),
])
def test_bound_matches_hand_worked(case, want_ms):
    assert ms(case) == pytest.approx(want_ms, abs=5e-5)


def test_from_feats_pieces():
    # 16 MiB a client at M = 2048: four clients a piece under 64 MiB
    assert counts.from_feats_pieces(6, 2048) == [(0, 4, 0, 2048),
                                                 (4, 6, 0, 2048)]
    # one client of M = 8192 (256 MiB) in bands of 2048 rows
    assert len(counts.from_feats_pieces(1, 8192)) == 4


def test_model_flops():
    # SmallCNN: ~17 MFLOP a trained sample (3 forward passes)
    assert 3 * smallcnn.forward_flops() == pytest.approx(17.03e6, rel=1e-3)
    # yi-9b at 4 layers: a step of 8 sequences of 128 tokens ~5.87 TFLOP
    cfg = dict(n_layers=4, d_model=4096, n_heads=32, n_kv_heads=4,
               d_head=128, d_ff=11008, vocab_size=64000)
    step = 3 * 8 * 128 * llama.forward_flops_per_token(cfg, 128)
    assert step == pytest.approx(5.87e12, rel=2e-3)
