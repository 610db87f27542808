"""The port's ``Model`` for the xLSTM, audio (encoder-decoder) and VLM
families against the JAX package's, from converted JAX inits: the smoke
configs of xlstm-125m (an mLSTM and an sLSTM block), whisper-tiny (2 + 2
layers, an encoder of 6 frames) and pixtral-12b (8 patches before the
tokens), and the configs of the reference's
``tests/test_decode_parity.py``.  Forward logits and last hidden state,
loss and one SGD step; decode rolled over the tokens against JAX's
decode and against the port's own forward (the audio model's over the
same encoder frames, the VLM's over no patches, as its decode never
sees them); ``cross_attention_decode``; the audio encoder's non-causal
attention through the kernel's plain version, at a ragged S; the tree's
list nodes through ``repro_torch.convert``.

Tolerances, as ``tests/test_torch_lm_model.py`` states them:
``LOGITS_ATOL`` 1e-4 on logits and hidden states, ``STEP_ATOL`` 1e-5 on
the parameters after one SGD step, ``DECODE_TOL`` 2e-4 on decode (the
reference's own 3e-4, tightened)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.training import make_train_step as j_step  # noqa: E402
from repro.optim.optimizers import sgd as j_sgd  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.training import make_train_step  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402

LOGITS_ATOL = 1e-4
STEP_ATOL = 1e-5
DECODE_TOL = 2e-4

XLSTM, WHISPER, PIXTRAL = "xlstm-125m", "whisper-tiny", "pixtral-12b"
# tests/test_decode_parity.py's xlstm and audio configs
PARITY = {
    "parity-xlstm": dict(arch_id="t", family="xlstm", n_layers=2,
                         d_model=32, n_heads=4, n_kv_heads=4, d_ff=0,
                         vocab_size=50, xlstm_pattern="ms"),
    "parity-audio": dict(arch_id="t", family="audio", n_layers=2,
                         enc_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
                         d_ff=64, vocab_size=50, act="gelu"),
    "parity-vlm": dict(arch_id="t", family="vlm", n_layers=2, d_model=32,
                       n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=50,
                       n_patches=4),
}
ARCHS = [XLSTM, WHISPER, PIXTRAL] + list(PARITY)
S_ENC = 6


def _models(arch, **kw):
    if arch in PARITY:
        jcfg = JConfig(**PARITY[arch]).with_(**kw)
        tcfg = ModelConfig(**PARITY[arch]).with_(**kw)
    else:
        jcfg = jconfigs.get_config(arch, smoke=True).with_(**kw)
        tcfg = tconfigs.get_config(arch, smoke=True).with_(**kw)
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax("dense", jax.tree.map(np.asarray, jp),
                         device="cpu")
    return jm, tm, jp, tp


def _batch(cfg, b=2, s=16, seed=1):
    """Tokens, labels and weights; the audio model's encoder frames or
    the VLM's patches, all from one numpy seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "weights": rng.uniform(0.5, 1.5, b).astype(np.float32)}
    batch["labels"][-1, -3:] = -100
    if cfg.family == "audio":
        batch["encoder_embeddings"] = rng.standard_normal(
            (b, S_ENC, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeddings"] = rng.standard_normal(
            (b, max(cfg.n_patches, 1), cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_train_step_match_reference(arch):
    jm, tm, jp, tp = _models(arch)
    jb, tb = _batch(tm.cfg)
    jl, jaux, jh = jm.forward(jp, jb)
    tl, aux, th = tm.forward(tp, tb)
    assert tuple(tl.shape) == (2, 16, tm.cfg.vocab_size)
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL,
                               rtol=LOGITS_ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=LOGITS_ATOL,
                               rtol=LOGITS_ATOL)
    (jloss, jmet), (tloss, tmet) = jm.loss(jp, jb), tm.loss(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tmet["per_example_loss"].detach().numpy(),
                               np.asarray(jmet["per_example_loss"]),
                               rtol=1e-5)
    # naive and kernel (its plain version on the CPU) attention agree
    # with the CPU default, the chunked one
    for impl in ("naive", "kernel"):
        other, _, _ = tm.forward(tp, tb, impl=impl)
        np.testing.assert_allclose(other.numpy(), tl.numpy(), atol=1e-5)
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


def _roll_j(jm, jp, tokens, seq_len, **kw):
    st = jm.init_decode_state(jp, tokens.shape[0], seq_len,
                              dtype=jnp.float32, **kw)
    step = jax.jit(jm.decode_step)
    outs = []
    for t in range(tokens.shape[1]):
        lg, st = step(jp, st, tokens[:, t:t + 1], jnp.asarray(t, jnp.int32))
        outs.append(np.asarray(lg))
    return np.concatenate(outs, axis=1)


def _roll_t(tm, tp, tokens, seq_len, **kw):
    st = tm.init_decode_state(tp, tokens.shape[0], seq_len,
                              dtype=torch.float32, **kw)
    outs = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            lg, st = tm.decode_step(tp, st, tokens[:, t:t + 1], t)
            outs.append(lg)
    return torch.cat(outs, dim=1), st


@pytest.mark.parametrize("arch,window", [(a, None) for a in ARCHS]
                         + [(WHISPER, 4)])
def test_decode_matches_reference_and_forward(arch, window):
    """9 tokens through ``decode_step`` (the audio model over the batch's
    encoder frames) against JAX's decode and the port's forward; the VLM
    against its forward over no patch (P = 0), as its decode never sees
    them."""
    jm, tm, jp, tp = _models(arch, attention_window=window)
    jb, tb = _batch(tm.cfg, s=9, seed=2)
    tokens = tb["tokens"]
    kw, jkw, fwd = {}, {}, {"tokens": tokens}
    if tm.cfg.family == "audio":
        kw = {"enc_embeddings": tb["encoder_embeddings"]}
        jkw = {"enc_embeddings": jb["encoder_embeddings"]}
        fwd["encoder_embeddings"] = tb["encoder_embeddings"]
    if tm.cfg.family == "vlm":
        fwd["patch_embeddings"] = torch.zeros((2, 0, tm.cfg.d_model))
    got, st = _roll_t(tm, tp, tokens, 16, **kw)
    want = _roll_j(jm, jp, jb["tokens"], 16, **jkw)
    np.testing.assert_allclose(got.numpy(), want, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    with torch.no_grad():
        full, _, _ = tm.forward(tp, fwd)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    if tm.cfg.family == "audio":
        assert tuple(st["enc_k"].shape) == (
            tm.cfg.n_layers, 2, S_ENC, tm.cfg.n_kv_heads, tm.cfg.d_head)
    if window:
        assert st["kv"]["k"].shape[2] == window


@pytest.mark.parametrize("seq_len", [8, 20, 10000])
def test_audio_decode_state_without_embeddings(seq_len):
    """Without frames, the encoder runs over zeros of min(max(1,
    int(seq_len·enc_seq_frac)), 4096) frames, as in the JAX package."""
    jm, tm, jp, tp = _models("parity-audio")
    n = 3 if seq_len == 10000 else 2
    st = tm.init_decode_state(tp, n, seq_len, dtype=torch.float32)
    jst = jm.init_decode_state(jp, n, seq_len, dtype=jnp.float32)
    s_enc = min(max(1, int(seq_len * tm.cfg.enc_seq_frac)), 4096)
    assert tuple(st["enc_k"].shape) == tuple(jst["enc_k"].shape) == (
        2, n, s_enc, 4, 8)
    if seq_len == 10000:
        return
    for k in ("enc_k", "enc_v"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    tokens = np.random.default_rng(3).integers(0, 50, (n, 6)).astype(
        np.int32)
    got, _ = _roll_t(tm, tp, torch.tensor(tokens), seq_len)
    want = _roll_j(jm, jp, jnp.asarray(tokens), seq_len)
    np.testing.assert_allclose(got.numpy(), want, atol=DECODE_TOL,
                               rtol=DECODE_TOL)


@pytest.mark.parametrize("frames", [False, True])
def test_audio_decode_state_at_the_default_dtype(frames):
    """At ``init_decode_state``'s default dtype, bf16, as in the JAX
    package: fp32 frames stay fp32 (plus the positions rounded to bf16),
    the zero encoder runs from bf16, and the KV caches are bf16.  The
    encoder K/V within ``LOGITS_ATOL`` of JAX's, the decode within
    ``DECODE_TOL``."""
    jm, tm, jp, tp = _models("parity-audio")
    jb, tb = _batch(tm.cfg, s=6, seed=4)
    kw = {"enc_embeddings": tb["encoder_embeddings"]} if frames else {}
    jkw = {"enc_embeddings": jb["encoder_embeddings"]} if frames else {}
    st = tm.init_decode_state(tp, 2, 12, **kw)
    jst = jm.init_decode_state(jp, 2, 12, **jkw)
    assert st["kv"]["k"].dtype == torch.bfloat16
    assert str(jst["kv"]["k"].dtype) == "bfloat16"
    for k in ("enc_k", "enc_v"):
        assert st[k].dtype == torch.float32
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    step = jax.jit(jm.decode_step)
    with torch.no_grad():
        for t in range(6):
            got, st = tm.decode_step(tp, st, tb["tokens"][:, t:t + 1], t)
            want, jst = step(jp, jst, jb["tokens"][:, t:t + 1],
                             jnp.asarray(t, jnp.int32))
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=DECODE_TOL, rtol=DECODE_TOL)


@pytest.mark.parametrize("hq,hk", [(4, 4), (4, 2)])
def test_cross_attention_decode_matches_reference(hq, hk):
    cfg = ModelConfig(d_model=32, n_heads=hq, n_kv_heads=hk)
    jcfg = JConfig(d_model=32, n_heads=hq, n_kv_heads=hk)
    jp = jattn.init_attention(jax.random.PRNGKey(0), jcfg, cross=True)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    own = tattn.init_attention(torch.Generator().manual_seed(0), cfg,
                               cross=True)
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: v.shape for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    ek = rng.standard_normal((3, 11, hk, 8)).astype(np.float32)
    ev = rng.standard_normal((3, 11, hk, 8)).astype(np.float32)
    want = jattn.cross_attention_decode(jp, jcfg, jnp.asarray(x),
                                        jnp.asarray(ek), jnp.asarray(ev))
    got = tattn.cross_attention_decode(tp, cfg, torch.tensor(x),
                                       torch.tensor(ek), torch.tensor(ev))
    assert tuple(got.shape) == (3, 1, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the same as full cross-attention of one query over the encoder
    enc = rng.standard_normal((3, 11, 32)).astype(np.float32)
    k = (torch.tensor(enc) @ tp["wk"]).reshape(3, 11, hk, 8)
    v = (torch.tensor(enc) @ tp["wv"]).reshape(3, 11, hk, 8)
    full = tattn.multihead_attention(tp, cfg, torch.tensor(x),
                                     causal=False, impl="naive",
                                     kv_x=torch.tensor(enc), use_rope=False)
    np.testing.assert_allclose(
        tattn.cross_attention_decode(tp, cfg, torch.tensor(x), k,
                                     v).numpy(), full.numpy(), atol=1e-5)


@pytest.mark.parametrize("s", [37, 100])
def test_audio_encoder_non_causal_at_a_ragged_length(s):
    """The encoder's frames at S = 37 and 100 (no multiple of the
    kernel's 64-key tile): the kernel's plain version (``impl="kernel"``,
    non-causal) against JAX's chunked encoder, within ``LOGITS_ATOL``."""
    jm, tm, jp, tp = _models(WHISPER)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tm.cfg.vocab_size, (1, 8)).astype(np.int32)
    enc = rng.standard_normal((1, s, tm.cfg.d_model)).astype(np.float32)
    want, _, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens),
                                 "encoder_embeddings": jnp.asarray(enc)})
    got, _, _ = tm.forward(tp, {"tokens": torch.tensor(tokens),
                                "encoder_embeddings": torch.tensor(enc)},
                           impl="kernel")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=LOGITS_ATOL)


@pytest.mark.parametrize("arch", [XLSTM, WHISPER, "parity-xlstm"])
def test_param_tree_list_nodes_round_trip(arch):
    """The xLSTM's ``blocks`` and the audio model's ``enc_layers`` /
    ``dec_layers`` are lists in the JAX tree and ``name.i.…`` keys here;
    ``params_to_jax`` rebuilds the lists, leaf for leaf."""
    jm, tm, jp, tp = _models(arch)
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert sorted(own) == sorted(tp)
    assert all(own[k].shape == tp[k].shape for k in tp)
    back = params_to_jax("dense", tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    cfg = tm.cfg
    if cfg.family == "xlstm":
        assert isinstance(back["blocks"], list)
        assert len(back["blocks"]) == len(cfg.xlstm_pattern)
        hd = cfg.d_model // cfg.n_heads
        assert tp["blocks.1.r"].shape == (4, cfg.n_heads, hd, hd)
        assert tp["blocks.0.norm.scale"].shape == (cfg.d_model,)
    else:
        assert [len(back["enc_layers"]), len(back["dec_layers"])] == [
            cfg.enc_layers, cfg.n_layers]
        assert "dec_layers.1.xattn.wq" in tp and "dec_layers.0.ln_x.scale" \
            in tp
        assert not any(k.startswith("enc_layers.0.xattn") for k in tp)
        assert tp["enc_ln.scale"].shape == (cfg.d_model,)


def test_convert_keeps_plain_dicts():
    """A tree without lists, and a dict whose keys are not indices, come
    back as dicts."""
    tree = {"a": {"b": np.ones(2, np.float32), "c1": np.zeros(1,
                                                             np.float32)},
            "l": [{"w": np.ones(3, np.float32)}, np.zeros(2, np.float32)]}
    flat = params_from_jax("mlp", tree, device="cpu")
    assert sorted(flat) == ["a.b", "a.c1", "l.0.w", "l.1"]
    back = params_to_jax("mlp", flat)
    assert isinstance(back["a"], dict) and isinstance(back["l"], list)
    np.testing.assert_array_equal(back["l"][0]["w"], tree["l"][0]["w"])
