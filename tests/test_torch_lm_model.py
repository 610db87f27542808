"""The port's decoder ``Model`` against the JAX package's, on the four
dense smoke configs (yi-9b, granite-20b's MQA, command-r-35b's tied
embeddings, mistral-large-123b) and a GQA config, and on the MoE, SSM
and hybrid families: the smoke configs of llama4-scout,
llama4-maverick and zamba2 (a shared attention block after every
Mamba2 layer), a GQA MoE config, an ``ssm`` config (zamba2's smoke
without the shared block, under ``remat``) and a hybrid with a tail (3
Mamba2 layers, the block after the second).  Forward logits, aux, loss
and one train step from converted JAX inits; decode rolled over 9
tokens against JAX's decode and against the port's own forward at the
reference's 2e-4, a sliding-window ring cache of 4 slots; the input
specs for every shape (the audio model's encoder frames and the VLM's
patches too); the parameter tree's round trip; an unknown family.
``tests/test_torch_lm_encdec.py`` holds the xLSTM, audio and VLM
families.

An MoE model's routing is checked for near-ties first: each layer's
smallest gap between the top two router probabilities must exceed
``TIE_GAP`` (XLA's and torch's router products round differently, about
1e-7).  Decode against the forward runs the MoE configs at a capacity
of every token, since the forward drops tokens that a decode step (cap
8 at batch 2) never does."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.models.moe as tmoe  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.training import make_train_step as j_step  # noqa: E402
from repro.optim.optimizers import sgd as j_sgd  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.training import make_train_step  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402

DENSE = ["yi-9b", "granite-20b", "command-r-35b", "mistral-large-123b"]
GQA = dict(arch_id="gqa", family="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=80)
SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
ZAMBA = "zamba2-1.2b"
MOE_GQA = dict(GQA, arch_id="moe-gqa", family="moe", n_experts=4)
# zamba2's smoke variant without its shared block, under remat; and a
# hybrid whose 3 layers leave a tail of 1 after the block
SPECIAL = {"gqa": GQA, "moe-gqa": MOE_GQA,
           "ssm": (ZAMBA, dict(family="ssm", attn_every=0, remat=True)),
           "hybrid-tail": (ZAMBA, dict(n_layers=3, attn_every=2))}
FAMILIES = [SCOUT, MAVERICK, ZAMBA, "moe-gqa", "ssm", "hybrid-tail"]
TIE_GAP = 1e-5
LOGITS_ATOL = 1e-4
STEP_ATOL = 1e-5
DECODE_TOL = 2e-4          # tests/test_decode_parity.py's 3e-4, tightened


def _configs(arch, **kw):
    if isinstance(SPECIAL.get(arch), dict):
        return (JConfig(**SPECIAL[arch]).with_(**kw),
                ModelConfig(**SPECIAL[arch]).with_(**kw))
    if arch in SPECIAL:
        arch, base = SPECIAL[arch]
        kw = {**base, **kw}
    return (jconfigs.get_config(arch, smoke=True).with_(**kw),
            tconfigs.get_config(arch, smoke=True).with_(**kw))


def _models(arch, **kw):
    jcfg, tcfg = _configs(arch, **kw)
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax("dense", jax.tree.map(np.asarray, jp),
                         device="cpu")
    return jm, tm, jp, tp


def _router_gap(tm, tp, tb):
    """The smallest top-2 router-probability gap over the MoE layers of
    a forward pass (inf without MoE layers)."""
    gaps = [float("inf")]
    real = tmoe._route

    def route(params, xt):
        probs, expert, gate = real(params, xt)
        top = torch.topk(probs, 2, dim=-1).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))
        return probs, expert, gate
    tmoe._route = route
    try:
        with torch.no_grad():
            tm.forward(tp, tb)
    finally:
        tmoe._route = real
    return min(gaps)


def _batch(vocab, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "weights": rng.uniform(0.5, 1.5, b).astype(np.float32)}
    batch["labels"][-1, -3:] = -100
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", DENSE + ["gqa"] + FAMILIES)
def test_forward_loss_and_train_step_match_reference(arch):
    jm, tm, jp, tp = _models(arch)
    jb, tb = _batch(tm.cfg.vocab_size)
    assert _router_gap(tm, tp, tb) > TIE_GAP
    jl, jaux, jh = jm.forward(jp, jb)
    tl, aux, th = tm.forward(tp, tb)
    assert tl.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    assert (float(aux) > 0) == (tm.cfg.n_experts > 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL,
                               rtol=LOGITS_ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=LOGITS_ATOL,
                               rtol=LOGITS_ATOL)
    (jloss, jmet), (tloss, tmet) = jm.loss(jp, jb), tm.loss(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tmet["per_example_loss"].detach().numpy(),
                               np.asarray(jmet["per_example_loss"]),
                               rtol=1e-5)
    # the forward's impl under the CPU default is the chunked one
    nl, _, _ = tm.forward(tp, tb, impl="naive")
    np.testing.assert_allclose(tl.numpy(), nl.numpy(), atol=1e-5)
    new_j, _, _ = j_step(jm.loss, j_sgd(0.5), donate=False)(
        jp, j_sgd(0.5).init(jp), jb)
    new_t, _, met = make_train_step(tm.loss, sgd(0.5))(
        tp, sgd(0.5).init(tp), tb)
    want = params_from_jax("dense", jax.tree.map(np.asarray, new_j),
                           device="cpu")
    assert sorted(new_t) == sorted(want)
    for k in want:
        np.testing.assert_allclose(new_t[k].numpy(), want[k].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=k)
    assert np.isfinite(float(met["loss"]))


def _roll_j(jm, jp, tokens, seq_len):
    st = jm.init_decode_state(jp, tokens.shape[0], seq_len,
                              dtype=jnp.float32)
    step = jax.jit(jm.decode_step)
    outs = []
    for t in range(tokens.shape[1]):
        lg, st = step(jp, st, tokens[:, t:t + 1], jnp.asarray(t, jnp.int32))
        outs.append(np.asarray(lg))
    return np.concatenate(outs, axis=1)


def _roll_t(tm, tp, tokens, seq_len):
    st = tm.init_decode_state(tp, tokens.shape[0], seq_len,
                              dtype=torch.float32)
    outs = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            lg, st2 = tm.decode_step(tp, st, tokens[:, t:t + 1], t)
            if "kv" in st:      # KV caches are written in place
                assert st2["kv"]["k"] is st["kv"]["k"]
            if "mamba" in st:   # a Mamba state comes back anew
                assert st2["mamba"].ssm.shape == st["mamba"].ssm.shape
            st = st2
            outs.append(lg)
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("arch,window", [(a, None) for a in DENSE]
                         + [("gqa", None), ("gqa", 4), ("yi-9b", 4)]
                         + [(a, None) for a in FAMILIES] + [("moe-gqa", 4)])
def test_decode_matches_reference_and_forward(arch, window):
    kw = {}
    if arch in (SCOUT, MAVERICK, "moe-gqa"):
        # a capacity of every token: the forward drops none either
        kw["moe_capacity_factor"] = 4.0
    jm, tm, jp, tp = _models(arch, attention_window=window, **kw)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tm.cfg.vocab_size, (2, 9)).astype(np.int32)
    got = _roll_t(tm, tp, torch.tensor(tokens), 16)
    want = _roll_j(jm, jp, jnp.asarray(tokens), 16)
    np.testing.assert_allclose(got.numpy(), want, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    assert _router_gap(tm, tp, {"tokens": torch.tensor(tokens)}) > TIE_GAP
    full, _, _ = tm.forward(tp, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(got.numpy(), full.detach().numpy(),
                               atol=DECODE_TOL, rtol=DECODE_TOL)
    if window:
        # a ring of `window` slots
        st = tm.init_decode_state(tp, 2, 16, dtype=torch.float32)
        assert st["kv"]["k"].shape[2] == window


@pytest.mark.parametrize("arch", DENSE + [SCOUT, MAVERICK, ZAMBA,
                                  "xlstm-125m", "whisper-tiny",
                                  "pixtral-12b"])
def test_input_specs_match_reference(arch):
    jm = JModel(jconfigs.get_config(arch))
    tm = Model(tconfigs.get_config(arch))
    for name, shape in tconfigs.SHAPES.items():
        want = jm.input_specs(jconfigs.SHAPES[name])
        got = tm.input_specs(shape)
        assert sorted(got) == sorted(want)
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == spec.shape, (name, k)
            assert str(got[k].dtype).split(".")[-1] == str(spec.dtype), k
        assert tm._text_len(shape.seq_len) == jm._text_len(shape.seq_len)


@pytest.mark.parametrize("arch", ["command-r-35b", "yi-9b", SCOUT, ZAMBA,
                                  "ssm", "hybrid-tail"])
def test_param_tree_round_trips(arch):
    """Stacked leaves map one to one: w_unembed, or command-r's and
    zamba2's tied embed, and every (L, ...) layer leaf, the MoE's
    ``layers.moe.*`` and ``layers.moe.shared.*``, the Mamba2 layers'
    ``layers.{w_in, conv_w, ...}`` (conv_w in the reference's (L, K, C)),
    the hybrid's unstacked ``shared_attn.*`` and ``shared_in``."""
    jm, tm, jp, tp = _models(arch)
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert sorted(own) == sorted(tp)
    assert all(own[k].shape == tp[k].shape for k in tp)
    assert ("w_unembed" in tp) == (not tm.cfg.tie_embeddings)
    back = params_to_jax("dense", tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    cfg = tm.cfg
    stacked = ("layers.w_in" if cfg.family in ("ssm", "hybrid")
               else "layers.attn.wq")
    assert tp[stacked].shape[0] == cfg.n_layers
    if cfg.n_experts:
        assert tp["layers.moe.w_gate"].shape == (
            cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
        assert "layers.moe.shared.w_down" in tp
    if cfg.family in ("ssm", "hybrid"):
        assert tp["layers.conv_w"].shape == (
            cfg.n_layers, cfg.ssm_conv, cfg.d_inner + 2 * cfg.ssm_state)
    assert ("shared_in" in tp) == (cfg.family == "hybrid")
    if cfg.family == "hybrid":
        assert tp["shared_in"].shape == (2 * cfg.d_model, cfg.d_model)
        assert tp["shared_attn.attn.wq"].dim() == 2


@pytest.mark.parametrize("arch", ["gqa", "moe-gqa", "ssm"])
def test_remat_matches_plain_forward_and_grads(arch):
    jm, tm, jp, tp = _models(arch)
    tm = Model(tm.cfg.with_(remat=False))
    rm = Model(tm.cfg.with_(remat=True))
    _, tb = _batch(tm.cfg.vocab_size)
    g1 = make_train_step(tm.loss, sgd(1.0))(tp, sgd(1.0).init(tp), tb)[0]
    g2 = make_train_step(rm.loss, sgd(1.0))(tp, sgd(1.0).init(tp), tb)[0]
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], atol=1e-6, rtol=0)


def test_init_draws_on_the_generator_device_and_is_seeded():
    tm = Model(ModelConfig(**GQA))
    a = tm.init(torch.Generator().manual_seed(3), device="cpu")
    b = tm.init(torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(a["layers.ln1.scale"], torch.ones(2, 64))


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown family"):
        Model(ModelConfig(family="rnn"))


def test_impl_resolves_by_device():
    tm = Model(ModelConfig(**GQA))
    assert tm.resolve_impl(None, torch.device("cpu")) == "chunked"
    assert tm.resolve_impl(None, torch.device("cuda")) == "kernel"
    assert tm.resolve_impl("naive", torch.device("cuda")) == "naive"
    _, tm, _, tp = _models("gqa")
    _, tb = _batch(tm.cfg.vocab_size)
    # impl="kernel" on the CPU is the kernel's plain version
    kl, _, _ = tm.forward(tp, tb, impl="kernel")
    cl, _, _ = tm.forward(tp, tb)
    np.testing.assert_allclose(kl.numpy(), cl.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="use_kernel=True"):
        Model(tm.cfg, use_kernel=True).forward(tp, tb)
