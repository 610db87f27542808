"""The port's checkpoints against the JAX package's file format.

The cases of the reference's ``tests/test_checkpoint.py`` on trees of
tensors (a structure round trip, nested dicts rebuilt without a
template, ``latest_checkpoint`` skipping a torn file, the meta round
trip, a missing directory), the dtype and device a template leaf gives,
and the format both ways: the same tree written by each package gives
the same npz members in the same order, the same ``__treedef__``
descriptor and the same meta JSON, a checkpoint of a JAX SmallCNN that
``repro.checkpoint`` wrote loads through the port and
``repro_torch.convert.params_from_jax`` to the port's converted params
exactly, and one the port wrote (``params_to_jax``, or its own flat
dotted keys) loads into the JAX package.
"""
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

import repro.checkpoint as jck  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import (latest_checkpoint,  # noqa: E402
                                    load_pytree, load_server_meta,
                                    load_server_state, save_pytree,
                                    save_server_state)
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402


def _tree():
    return {"a": {"b": torch.ones((3, 2)), "c": torch.arange(4)},
            "d": [torch.zeros(2), torch.full((2, 2), 7.0)]}


def _leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_roundtrip_with_structure(tmp_path):
    tree = _tree()
    path = str(tmp_path / "x.npz")
    save_pytree(path, tree)
    back = load_pytree(path, like=tree)
    assert list(back) == list(tree) and isinstance(back["d"], list)
    assert _equal(tree, back)


def test_roundtrip_nested_dict_reconstruction(tmp_path):
    tree = {"x": {"y": torch.ones(3)}, "z": torch.zeros(2)}
    path = str(tmp_path / "y.npz")
    save_pytree(path, tree)
    back = load_pytree(path, device="cpu")
    assert torch.equal(back["x"]["y"], torch.ones(3))
    # a legacy file (no descriptor) rebuilds nested dicts from the paths
    np.savez(str(tmp_path / "legacy.npz"),
             **{"x/y": np.ones(3, np.float32), "z": np.zeros(2)})
    legacy = load_pytree(str(tmp_path / "legacy.npz"), device="cpu")
    assert torch.equal(legacy["x"]["y"], torch.ones(3))
    assert legacy["z"].dtype == torch.float64


def test_server_state_resume(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    for r in (0, 3, 7):
        save_server_state(d, r, tree, extra={"note": "test"})
    assert latest_checkpoint(d).endswith("ckpt_000007.npz")
    params, rnd = load_server_state(d, like=tree)
    assert rnd == 7
    assert _equal(tree, params)


def test_load_missing_returns_none(tmp_path):
    params, rnd = load_server_state(str(tmp_path / "nope"))
    assert params is None and rnd == -1
    assert latest_checkpoint(str(tmp_path / "nope")) is None


def test_roundtrip_without_like_preserves_dtypes_and_treedef(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "opt": (torch.full((2,), 0.5), np.arange(3, dtype=np.int64)),
            "log": [np.float64(1.5), np.ones(2, np.float32)],
            "flag": None}
    path = str(tmp_path / "d.npz")
    save_pytree(path, tree)
    back = load_pytree(path, device="cpu")
    assert set(back) == set(tree) and back["flag"] is None
    assert isinstance(back["opt"], tuple) and isinstance(back["log"], list)
    for a, b in zip(_leaves(tree), _leaves(back)):
        a = torch.as_tensor(a)
        assert b.dtype == a.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)


def test_like_gives_each_leaf_its_template_dtype_and_device(tmp_path):
    path = str(tmp_path / "t.npz")
    save_pytree(path, {"w": torch.arange(4.0), "n": torch.tensor(3)})
    like = {"w": torch.zeros(4, dtype=torch.float64), "n": np.int64(0)}
    back = load_pytree(path, like=like, device="cpu")
    assert back["w"].dtype == torch.float64
    assert torch.equal(back["w"], torch.arange(4.0, dtype=torch.float64))
    assert back["n"].dtype == torch.int64 and int(back["n"]) == 3


def test_latest_checkpoint_skips_unreadable_files(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    save_server_state(d, 2, tree)
    # a partly written (garbage) npz with a higher round number must not
    # shadow the last good checkpoint
    with open(os.path.join(d, "ckpt_000009.npz"), "wb") as f:
        f.write(b"\x00not-a-zipfile")
    assert latest_checkpoint(d).endswith("ckpt_000002.npz")
    params, rnd = load_server_state(d, like=tree)
    assert rnd == 2 and params is not None
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]


def test_load_server_meta_roundtrip(tmp_path):
    d = str(tmp_path)
    save_server_state(d, 5, _tree(),
                      extra={"kind": "fleet", "rng": [1, 2, 3]})
    meta = load_server_meta(d)
    assert meta["kind"] == "fleet" and meta["round"] == 5
    assert meta["rng"] == [1, 2, 3]
    assert load_server_meta(str(tmp_path / "nope")) is None


def test_flat_dotted_keys_are_one_dict_level(tmp_path):
    params = {"lstm0.wx": torch.ones(2, 8), "lstm0.b": torch.zeros(8),
              "embed": torch.full((3, 2), 0.5)}
    path = str(tmp_path / "p.npz")
    save_pytree(path, params)
    with np.load(path) as data:
        assert data.files[:3] == ["embed", "lstm0.b", "lstm0.wx"]
    back = load_pytree(path, device="cpu")
    assert list(back) == list(params) and _equal(params, back)


def _jax_cnn_tree():
    model = jsmall.SmallCNN(image_size=8, channels=(4, 8))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


def test_same_tree_same_members_descriptor_and_meta(tmp_path):
    """The npz members (names, order, arrays), the descriptor and the meta
    JSON of one tree are the same whichever package wrote them."""
    jtree = {"params": _jax_cnn_tree(),
             "opt": [np.arange(3, dtype=np.int64), None]}
    ttree = {"params": {k: torch.tensor(v)
                        for k, v in jtree["params"].items()},
             "opt": [torch.arange(3), None]}
    extra = {"kind": "fleet", "history": [{"round": 0, "loss": 0.25}],
             "rng_state": {"state": {"state": 2 ** 100, "inc": 7}}}
    jck.save_server_state(str(tmp_path / "j"), 4, jtree, extra=extra)
    save_server_state(str(tmp_path / "t"), 4, ttree, extra=extra)
    with np.load(str(tmp_path / "j" / "ckpt_000004.npz")) as a, \
            np.load(str(tmp_path / "t" / "ckpt_000004.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert (tmp_path / "j" / "ckpt_000004.json").read_bytes() == \
        (tmp_path / "t" / "ckpt_000004.json").read_bytes()


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jp = _jax_cnn_tree()
    d = str(tmp_path)
    jck.save_server_state(d, 3, jp, extra={"kind": "fleet"})
    want = params_from_jax("cnn", jp, device="cpu")
    tree, rnd = load_server_state(d, device="cpu")
    assert rnd == 3 and load_server_meta(d)["kind"] == "fleet"
    got = params_from_jax("cnn", {k: v.numpy() for k, v in tree.items()},
                          device="cpu")
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # with a template of tensors: the same leaves, as the template's
    like = {k: torch.zeros(v.shape) for k, v in jp.items()}
    tree, _ = load_server_state(d, like=like)
    assert all(torch.equal(tree[k], torch.as_tensor(jp[k])) for k in jp)


def test_port_checkpoint_loads_into_jax(tmp_path):
    jp = _jax_cnn_tree()
    tp = params_from_jax("cnn", jp, device="cpu")
    d = str(tmp_path / "cnn")
    save_server_state(d, 6, params_to_jax("cnn", tp),
                      extra={"kind": "fleet"})
    back, rnd = jck.load_server_state(d, like=jp)
    assert rnd == 6
    for k in jp:
        np.testing.assert_array_equal(np.asarray(back[k]), jp[k])
    # the port's own flat dict of dotted keys loads as one dict level
    lstm = {"lstm0.wx": torch.randn(2, 8), "lstm0.b": torch.zeros(8)}
    save_server_state(str(tmp_path / "lstm"), 1, lstm)
    back, _ = jck.load_server_state(str(tmp_path / "lstm"))
    assert sorted(back) == ["lstm0.b", "lstm0.wx"]
    for k, v in lstm.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v.numpy())


def test_checkpoint_exports_the_reference_names():
    import repro_torch.checkpoint as tck

    want = {n for n in dir(jck) if not n.startswith("_")}
    got = {n for n in dir(tck) if not n.startswith("_")}
    assert want == got
