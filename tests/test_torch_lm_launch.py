"""The port's LM launchers against the JAX package's: the synthetic
stream byte for byte, greedy generation on the ``tiny`` preset token for
token from converted params, centralized training (the loss falls, the
checkpoint reads back in both packages, every step's loss equal to the
reference's from the same weights) and FedCore-for-LM (the history's
timing, coreset counts, selected coresets and round losses equal the
reference's)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
import repro.launch.train as jtrain  # noqa: E402
import repro_torch.launch.serve as tserve  # noqa: E402
import repro_torch.launch.train as ttrain  # noqa: E402
from repro.checkpoint import load_server_state as j_load  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.checkpoint import load_server_state  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


def test_presets_equal_reference():
    assert list(ttrain.PRESETS) == list(jtrain.PRESETS)
    for k, cfg in jtrain.PRESETS.items():
        assert ttrain.PRESETS[k].__dict__ == cfg.__dict__


@pytest.mark.parametrize("vocab,batch,seq,seed", [(64, 4, 16, 0),
                                                  (512, 3, 33, 7)])
def test_synthetic_stream_byte_identical(vocab, batch, seq, seed):
    jg = jtrain.synthetic_stream(vocab, batch, seq, seed)
    tg = ttrain.synthetic_stream(vocab, batch, seq, seed, device="cpu")
    for _ in range(3):
        jb, tb = next(jg), next(tg)
        for k in ("tokens", "labels", "weights"):
            want = np.asarray(jb[k])
            got = tb[k].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), k


def test_greedy_generate_matches_reference():
    cfg = jtrain.PRESETS["tiny"]
    jm, tm = JModel(cfg), Model(ttrain.PRESETS["tiny"])
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax("dense", jax.tree.map(np.asarray, jp),
                         device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(prompts), 32))
    got = tserve.generate(tm, tp, torch.tensor(prompts), 32)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    # the first new token is the forward's argmax at the last prompt
    # position
    logits, _, _ = tm.forward(tp, {"tokens": torch.tensor(prompts)})
    np.testing.assert_array_equal(got[:, 16].numpy(),
                                  logits[:, -1].argmax(-1).numpy())


def test_temperature_generate_draws_from_its_generator():
    tm = Model(ttrain.PRESETS["tiny"])
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.zeros((2, 3), dtype=torch.int32)
    a = tserve.generate(tm, tp, prompts, 6, temperature=1.0, seed=4)
    b = tserve.generate(tm, tp, prompts, 6, temperature=1.0, seed=4)
    assert torch.equal(a, b) and tuple(a.shape) == (2, 9)
    assert int(a.max()) < tm.cfg.vocab_size


def _init_from_jax(monkeypatch, seed):
    """Make the port's ``Model.init`` return the JAX package's
    ``Model(cfg).init(PRNGKey(seed))`` converted, so both launchers start
    from the same weights."""
    def init(self, generator, device=None):
        jp = JModel(self.cfg).init(jax.random.PRNGKey(seed))
        return params_from_jax("dense", jax.tree.map(np.asarray, jp),
                               device="cpu")
    monkeypatch.setattr(ttrain.Model, "init", init)


def test_train_centralized_checkpoint_reads_back(tmp_path, monkeypatch):
    _init_from_jax(monkeypatch, seed=0)
    kw = dict(steps=12, batch=8, seq=64, lr=1e-3, log_every=100, seed=0)
    want = jtrain.train_centralized(jtrain.PRESETS["tiny"], ckpt_dir=None,
                                    **kw)
    out = ttrain.train_centralized(ttrain.PRESETS["tiny"],
                                   ckpt_dir=str(tmp_path), device="cpu",
                                   **kw)
    assert out["final_loss"] < out["initial_loss"]
    # every step's loss is the reference's on the same weights and data
    np.testing.assert_allclose(out["losses"], want["losses"], rtol=0,
                               atol=1e-5)
    params = out["params"]
    loaded, step = load_server_state(str(tmp_path), like=params)
    assert step == 12
    assert all(torch.equal(loaded[k], params[k]) for k in params)
    jtree, jstep = j_load(str(tmp_path))
    assert jstep == 12
    back = params_from_jax("dense", jax.tree.map(np.asarray, jtree),
                           device="cpu")
    assert sorted(back) == sorted(params)
    assert all(torch.equal(back[k], params[k]) for k in params)


def _record_coresets(monkeypatch, module, to_numpy):
    """Wrap ``module.build_coreset`` to record each call's features,
    budget, indices and weights, in call order."""
    calls = []
    real = module.build_coreset

    def recording(features, budget, **kwargs):
        cs = real(features, budget, **kwargs)
        calls.append((to_numpy(features), budget,
                      to_numpy(cs.indices).tolist(),
                      to_numpy(cs.weights).tolist()))
        return cs
    monkeypatch.setattr(module, "build_coreset", recording)
    return calls, real


def test_train_fedcore_lm_history_matches_reference(capsys, monkeypatch):
    import repro.core.coreset as jcoreset
    import repro_torch.core.coreset as tcoreset
    _init_from_jax(monkeypatch, seed=0)
    want_calls, _ = _record_coresets(monkeypatch, jcoreset, np.asarray)
    got_calls, port_build = _record_coresets(
        monkeypatch, tcoreset, lambda t: t.detach().cpu().numpy())

    kw = dict(rounds=2, steps_per_epoch=3, silos=4, batch=4, seq=16,
              lr=1e-3, straggler_pct=30.0, seed=0)
    want = jtrain.train_fedcore_lm(jtrain.PRESETS["tiny"], **kw)
    got = ttrain.train_fedcore_lm(ttrain.PRESETS["tiny"], device="cpu", **kw)
    assert len(got["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        for key in ("round", "round_time", "tau", "coreset_silos"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=0, atol=1e-5)
    assert [cs for rnd in got["coresets"] for cs in rnd.values()] == [
        c[2] for c in got_calls]
    assert len(got_calls) == len(want_calls) == sum(
        h["coreset_silos"] for h in got["history"]) > 0
    for (gf, gb, gi, gw), (wf, wb, wi, ww) in zip(got_calls, want_calls):
        # the last-layer gradient features of the same silo and round
        assert gb == wb and gf.shape == wf.shape
        np.testing.assert_allclose(gf, wf, rtol=0, atol=1e-6)
        # the same coreset: each medoid with its weight δ (the slot order
        # follows FasterPAM's swap order, which float-level differences
        # in the features may reorder between equal-cost swaps)
        assert dict(zip(gi, gw)) == dict(zip(wi, ww))
        # and on the reference's own features the port selects exactly
        # the reference's slots
        cs = port_build(torch.from_numpy(wf.copy()), wb)
        assert cs.indices.tolist() == wi and cs.weights.tolist() == ww
    assert "[fedcore-lm] round 1" in capsys.readouterr().out


def test_main_runs_on_the_cpu(capsys):
    out = tserve.main(["--arch", "tiny", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--gen", "3"])
    assert tuple(out.shape) == (2, 7)
    res = ttrain.main(["--preset", "tiny", "--steps", "4", "--batch", "4",
                       "--seq", "16", "--lr", "3e-3", "--device", "cpu"])
    assert res["final_loss"] < res["initial_loss"]
    res = ttrain.main(["--preset", "yi-9b", "--fedcore", "--rounds", "1",
                       "--steps", "2", "--batch", "2", "--seq", "8",
                       "--device", "cpu"])
    assert len(res["history"]) == 1
    text = capsys.readouterr().out
    assert "[serve] arch=tiny-lm" in text and "[train] step" in text


def _jax_prompts(monkeypatch, argv):
    """The JAX launcher's prompts for ``argv``, and ``torch.randint``
    patched to hand the port's launcher the same ones."""
    seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv else 0
    b = int(argv[argv.index("--batch") + 1])
    p_len = int(argv[argv.index("--prompt-len") + 1])
    cfg = jserve.get_config(argv[argv.index("--arch") + 1], smoke=True)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed + 1),
                                         (b, p_len), 0, cfg.vocab_size))
    real = torch.randint

    def randint(low, high, size, **kw):
        if tuple(size) != (b, p_len):
            return real(low, high, size, **kw)
        assert (low, high) == (0, cfg.vocab_size)
        return torch.tensor(want, dtype=kw.get("dtype"),
                            device=kw.get("device"))
    monkeypatch.setattr(torch, "randint", randint)
    return want


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "zamba2-1.2b",
                                  "llama4-maverick-400b-a17b", "xlstm-125m",
                                  "whisper-tiny", "pixtral-12b"])
def test_serve_cli_smoke_matches_reference(arch, monkeypatch, capsys):
    """``serve --arch A --smoke`` from the JAX launcher's weights and
    prompts gives its greedy tokens, token for token: the MoE decode (cap
    8 at batch 4, every expert on 8 mostly empty rows), the hybrid's
    Mamba states and shared-block KV caches, the xLSTM blocks' states,
    whisper over the zero encoder of 10 frames that ``init_decode_state``
    makes for a cache of 20, and pixtral's decode, which never sees a
    patch."""
    argv = ["--arch", arch, "--smoke", "--batch", "4", "--prompt-len", "8",
            "--gen", "12"]
    want = np.asarray(jserve.main(argv))
    _init_from_jax(monkeypatch, seed=0)
    prompts = _jax_prompts(monkeypatch, argv)
    np.testing.assert_array_equal(want[:, :8], prompts)
    got = tserve.main(argv + ["--device", "cpu"])
    assert tuple(got.shape) == (4, 20) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert f"[serve] arch={arch}" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "zamba2-1.2b",
                                  "xlstm-125m"])
def test_train_centralized_new_families_match_reference(arch, monkeypatch):
    """``train --preset A`` (the smoke config): every step's loss, the
    MoE's aux term included, is the reference's on the same weights and
    data."""
    _init_from_jax(monkeypatch, seed=0)
    kw = dict(steps=10, batch=4, seq=32, lr=1e-3, log_every=100, seed=0)
    cfg = jtrain.get_config(arch, smoke=True)
    want = jtrain.train_centralized(cfg, ckpt_dir=None, **kw)
    out = ttrain.train_centralized(ttrain.get_config(arch, smoke=True),
                                   ckpt_dir=None, device="cpu", **kw)
    np.testing.assert_allclose(out["losses"], want["losses"], rtol=0,
                               atol=1e-5)
    res = ttrain.main(["--preset", arch, "--steps", "10", "--batch", "4",
                       "--seq", "32", "--lr", "1e-3", "--device", "cpu"])
    assert res["final_loss"] < res["initial_loss"]


@pytest.mark.parametrize("arch,key", [("whisper-tiny", "encoder_embeddings"),
                                      ("pixtral-12b", "patch_embeddings")])
def test_train_audio_and_vlm_raise_key_error_as_reference(arch, key):
    """The synthetic stream yields tokens only, so the audio and VLM
    forwards find no frames or patches: ``KeyError`` in both packages'
    ``train_centralized`` and ``train_fedcore_lm`` alike."""
    kw = dict(steps=2, batch=2, seq=8, lr=1e-3, log_every=100, seed=0)
    fkw = dict(rounds=1, steps_per_epoch=2, silos=2, batch=2, seq=8,
               lr=1e-3, straggler_pct=50.0, seed=0)
    jcfg = jtrain.get_config(arch, smoke=True)
    tcfg = ttrain.get_config(arch, smoke=True)
    with pytest.raises(KeyError, match=key):
        jtrain.train_centralized(jcfg, ckpt_dir=None, **kw)
    with pytest.raises(KeyError, match=key):
        ttrain.train_centralized(tcfg, ckpt_dir=None, device="cpu", **kw)
    with pytest.raises(KeyError, match=key):
        jtrain.train_fedcore_lm(jcfg, **fkw)
    with pytest.raises(KeyError, match=key):
        ttrain.train_fedcore_lm(tcfg, device="cpu", **fkw)
