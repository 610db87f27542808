"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, leaf by leaf: ``param_specs`` for every arch in both
modes on both production meshes, ``batch_specs`` for every arch x shape,
``decode_state_specs`` for every arch x decode shape with and without
context parallelism; the reference test's ``_fit`` cases and the
spec-to-placements helper.  The JAX side is ``jax.eval_shape``, the
port's side a ``FakeTensorMode`` init and meta tensors: nothing is
allocated."""
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import ARCH_IDS, get_config as jax_config  # noqa: E402
from repro.configs.base import SHAPES  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch.dryrun import abstract_params  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


class FakeMesh:
    """Duck-typed mesh exposing .shape and .axis_names only (the reference
    test's)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


class NamedMesh:
    """Duck-typed ``DeviceMesh``: ``mesh_dim_names`` and a ``shape``
    tuple."""

    def __init__(self, shape: dict):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
DECODE_SHAPES = [s for s in SHAPES if SHAPES[s].kind == "decode"]


def _norm(sp):
    t = tuple(sp)
    while t and t[-1] is None:
        t = t[:-1]
    return t


def _canon(spec) -> tuple:
    """A spec's entries, a one-name tuple read as the name (JAX's
    ``PartitionSpec`` keeps ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _port_key(path) -> str:
    """A JAX tree path as the port's flat parameter key."""
    return ".".join(jsh._p(p).lstrip("#") for p in path)


def _jax_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(jsh._p(p) for p in path): _canon(sp)
            for path, sp in leaves}


def _port_specs(tree):
    out = {}
    tsh.map_with_path(lambda key, sp: out.__setitem__(key, _canon(sp)), tree)
    return out


@functools.lru_cache(maxsize=None)
def _params(arch):
    jshapes = jax.eval_shape(JaxModel(jax_config(arch)).init,
                             jax.random.PRNGKey(0))
    return jshapes, abstract_params(Model(get_config(arch)))


def test_fit_drops_nondivisible():
    mesh = FakeMesh(MESHES["single"])
    mesh3 = FakeMesh(MESHES["multi"])
    assert _norm(tsh._fit(P("model"), (10,), mesh)) == ()
    assert _norm(tsh._fit(P("model"), (32,), mesh)) == ("model",)
    assert _norm(tsh._fit(P(("pod", "data")), (64, 8), mesh3)) == (
        ("pod", "data"),)
    assert _norm(tsh._fit(P(("pod", "data")), (30, 8), mesh3)) == ()
    # a DeviceMesh's names and shape read the same
    assert _norm(tsh._fit(P(("pod", "data")), (64, 8),
                          NamedMesh(MESHES["multi"]))) == (("pod", "data"),)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mode, mesh_kind):
    jshapes, tshapes = _params(arch)
    want = jsh.param_specs(jax_config(arch), jshapes,
                           FakeMesh(MESHES[mesh_kind]), mode=mode)
    got = tsh.param_specs(get_config(arch), tshapes,
                          NamedMesh(MESHES[mesh_kind]), mode=mode)
    want = {_port_key(path): _canon(sp) for path, sp in
            jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, JP))[0]}
    assert {k: _canon(v) for k, v in got.items()} == want
    # the reference's own rule checks hold on the port's side
    if arch == "yi-9b" and mode == "tp" and mesh_kind == "single":
        assert got["layers.attn.wq"] == (None, None, "model")
        assert got["embed"] == ("model", None)
        assert _norm(got["ln_f.scale"]) == ()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_reference(arch, shape):
    jspecs = JaxModel(jax_config(arch)).input_specs(SHAPES[shape])
    tspecs = Model(get_config(arch)).input_specs(SHAPES[shape])
    for kind, mesh in MESHES.items():
        want = jsh.batch_specs(jspecs, FakeMesh(mesh))
        got = tsh.batch_specs(tspecs, NamedMesh(mesh))
        assert _port_specs(got) == _jax_specs(want), kind


@pytest.mark.parametrize("context_parallel", [False, True])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_specs_equal_reference(arch, shape, context_parallel):
    shp = SHAPES[shape]
    jmodel = JaxModel(jax_config(arch))
    jshapes, tshapes = _params(arch)
    jstate = jax.eval_shape(
        lambda p: jmodel.init_decode_state(p, shp.global_batch, shp.seq_len),
        jshapes)
    with torch.no_grad():
        tstate = Model(get_config(arch)).init_decode_state(
            tshapes, shp.global_batch, shp.seq_len)
    for kind, mesh in MESHES.items():
        want = jsh.decode_state_specs(jax_config(arch), jstate,
                                      FakeMesh(mesh), context_parallel)
        got = tsh.decode_state_specs(get_config(arch), tstate,
                                     NamedMesh(mesh), context_parallel)
        assert _port_specs(got) == _jax_specs(want), kind
        shapes = {}
        tsh.map_with_path(lambda k, t: shapes.__setitem__(k, tuple(t.shape)),
                          tstate)
        assert shapes == {k: tuple(v.shape) for k, v in _jax_leaves(jstate)}


def _jax_leaves(tree):
    return [("/".join(jsh._p(p) for p in path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_decode_state_rules_of_the_reference_tests():
    """``tests/test_sharding.py``'s MQA and context-parallel cases."""
    mesh = NamedMesh(MESHES["single"])
    with torch.no_grad():
        granite = Model(get_config("granite-20b")).init_decode_state(
            abstract_params(Model(get_config("granite-20b"))), 128, 1024)
        mistral = Model(get_config("mistral-large-123b")).init_decode_state(
            abstract_params(Model(get_config("mistral-large-123b"))), 128,
            32768)
    kv = tuple(tsh.decode_state_specs(get_config("granite-20b"), granite,
                                      mesh)["kv"]["k"])
    assert len(kv) < 4 or kv[3] is None
    kv = tuple(tsh.decode_state_specs(get_config("mistral-large-123b"),
                                      mistral, mesh,
                                      context_parallel=True)["kv"]["k"])
    assert kv[2] == "model"


@pytest.mark.parametrize("spec,want", [
    (P(), [Replicate(), Replicate(), Replicate()]),
    (P(None, "model"), [Replicate(), Replicate(), Shard(1)]),
    (P(("pod", "data"), "model"), [Shard(0), Shard(0), Shard(1)]),
    (P("data", None, "model"), [Replicate(), Shard(0), Shard(2)]),
])
def test_spec_placements(spec, want):
    mesh = NamedMesh(MESHES["multi"])
    assert tsh.spec_placements(spec, mesh) == want


def test_spec_placements_rejects_axes_out_of_mesh_order():
    with pytest.raises(ValueError, match="order"):
        tsh.spec_placements(P(("data", "pod")), NamedMesh(MESHES["multi"]))


def test_local_shape():
    mesh = NamedMesh(MESHES["multi"])
    assert tsh.local_shape((64, 4096, 8), P(("pod", "data"), "model"),
                           mesh) == (2, 256, 8)
