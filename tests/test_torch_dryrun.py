"""The port's shape-only dry run (``repro_torch.launch.dryrun``): the
JAX package's integration test's two combinations through ``python -m
repro_torch.launch.dryrun``, the record's counts against the reference
config's and the reference's own specs, the FLOPs of a one-rank mesh
against ``FlopCounterMode`` on the unsharded step, and the module's
import without side effects.  Every world starts in a subprocess: a
process group is process-global."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import SHAPES  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch.dryrun import abstract_params as jax_abstract  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    for k in ("REPRO_DRYRUN_FORCE_DEVICES", "XLA_FLAGS"):
        if k not in extra:
            env.pop(k, None)
    return env


def _python(code: str, **env) -> str:
    out = subprocess.run([sys.executable, "-c", code], env=_env(**env),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


COMBOS = {
    "whisper-tiny": ["--arch", "whisper-tiny", "--shape", "decode_32k",
                     "--mesh", "single"],
    "yi-9b": ["--arch", "yi-9b", "--shape", "prefill_32k", "--mesh",
              "multi"],
}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The CLI's record of each of ``COMBOS``."""
    out = {}
    for arch, args in COMBOS.items():
        path = tmp_path_factory.mktemp("dryrun") / "rec.jsonl"
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", str(path)], env=_env(), cwd=ROOT,
            capture_output=True, text=True, timeout=TIMEOUT)
        assert res.returncode == 0, res.stderr[-3000:]
        assert "1/1 combinations traced" in res.stdout
        out[arch] = json.loads(path.read_text().splitlines()[-1])
    return out


@pytest.mark.parametrize("arch", list(COMBOS))
def test_dryrun_single_combination(records, arch):
    """``tests/test_dryrun_integration.py``'s checks."""
    rec = records[arch]
    assert rec["ok"], rec
    assert rec["arch"] == arch
    assert rec["memory"]["bytes_per_device"] > 0
    assert rec["cost"].get("flops", 0) > 0
    assert "total_bytes" in rec["collectives"]
    assert set(rec["collectives"]["counts"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}


@pytest.mark.parametrize("arch", list(COMBOS))
def test_record_counts_equal_reference(records, arch):
    rec = records[arch]
    shape = SHAPES[rec["shape"]]
    cfg = jax_config(arch, shape=shape)
    assert rec["params"] == cfg.param_count()
    assert rec["active_params"] == cfg.active_param_count()
    want = ({"pod": 2, "data": 16, "model": 16} if rec["mesh"] == "multi"
            else {"data": 16, "model": 16})
    assert rec["mesh_shape"] == want
    for key in ("sharding", "context_parallel", "remat", "optimizer"):
        assert key in rec


class _JaxMesh:
    """Duck-typed mesh for the reference's specs."""

    def __init__(self, shape):
        self.shape, self.axis_names = shape, tuple(shape)


def _local_bytes(shape, spec, mesh, itemsize):
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    n = 1
    for dim, axis in zip(shape, spec):
        n *= dim // jsh._axis_size(mesh, axis)
    return n * itemsize


def test_argument_bytes_equal_reference_specs(records):
    """yi-9b x prefill_32k x multi: the record's argument bytes a device
    are the local shard bytes the JAX package's own specs give its bf16
    params and its batch, counted here without a compile."""
    rec = records["yi-9b"]
    shape = SHAPES["prefill_32k"]
    cfg = jax_config("yi-9b", shape=shape)
    model = JaxModel(cfg)
    mesh = _JaxMesh(rec["mesh_shape"])
    params = jax_abstract(model)
    specs = jsh.param_specs(cfg, params, mesh)
    inputs = model.input_specs(shape)
    bspecs = jsh.batch_specs(inputs, mesh)
    want = 0
    for tree, spec_tree in ((params, specs), (inputs, bspecs)):
        leaves = jax.tree_util.tree_leaves(tree)
        spec_leaves = jax.tree_util.tree_leaves(
            spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                    PartitionSpec))
        want += sum(_local_bytes(leaf.shape, sp, mesh,
                                 np.dtype(leaf.dtype).itemsize)
                    for leaf, sp in zip(leaves, spec_leaves))
    assert rec["memory"]["argument_size_in_bytes"] == want


_ONE_RANK = """
import json, torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models.model import Model

dryrun.force_world(1)
dryrun.make_production_mesh = lambda multi_pod=False: DeviceMesh(
    "cpu", [[0]], mesh_dim_names=("data", "model"))
smoke = {a: get_config(a, smoke=True) for a in ARCHS}
dryrun.get_config = lambda a, shape=None: smoke[a]
SHAPES["small_train"] = SHAPES["train_4k"].__class__(
    "small_train", 64, 4, "train")
SHAPES["small_prefill"] = SHAPES["prefill_32k"].__class__(
    "small_prefill", 64, 4, "prefill")
out = {}
for arch in ARCHS:
    for name in ("small_train", "small_prefill"):
        shape = SHAPES[name]
        rec = dryrun.dry_run(arch, name, verbose=False)
        model = Model(smoke[arch])
        params = dryrun.abstract_params(model)
        batch = model.input_specs(shape, dtype=dryrun.DTYPE)
        step, opt = dryrun.build_step(model, shape)
        if shape.kind == "train":
            params = {k: v.requires_grad_() for k, v in params.items()}
            args = (params, opt.init(params), batch)
        else:
            args = (params, batch)
        with FlopCounterMode(display=False) as fc:
            step(*args)
        out[f"{arch} {name}"] = [rec["cost"]["flops"], fc.get_total_flops(),
                                 rec["collectives"]["total_bytes"]]
print(json.dumps(out))
"""

ONE_RANK_ARCHS = ["yi-9b", "llama4-scout-17b-a16e", "zamba2-1.2b",
                  "xlstm-125m", "whisper-tiny"]


@pytest.fixture(scope="module")
def one_rank():
    return json.loads(_python(
        f"ARCHS = {ONE_RANK_ARCHS!r}\n" + _ONE_RANK).splitlines()[-1])


@pytest.mark.parametrize("kind", ["small_train", "small_prefill"])
@pytest.mark.parametrize("arch", ONE_RANK_ARCHS)
def test_one_rank_flops_equal_unsharded_step(one_rank, arch, kind):
    """On a (1, 1) mesh every op is local: the dry run's FLOPs are
    ``FlopCounterMode``'s of the plain step on meta tensors, and no byte
    moves between ranks."""
    flops, want, coll = one_rank[f"{arch} {kind}"]
    assert want > 0 and flops == want
    assert coll == 0


def test_dryrun_import_has_no_side_effect():
    out = _python("import torch.distributed as dist, "
                  "repro_torch.launch.dryrun; "
                  "print(dist.is_initialized())")
    assert out.strip() == "False"


def test_dryrun_import_opt_in_forces_devices():
    """``REPRO_DRYRUN_FORCE_DEVICES=N`` opts a library import into a fake
    world of N ranks (``test_dryrun_integration.py``'s opt-in)."""
    out = _python("import torch.distributed as dist, "
                  "repro_torch.launch.dryrun; "
                  "print(dist.get_backend(), dist.get_world_size())",
                  REPRO_DRYRUN_FORCE_DEVICES="8")
    assert out.split() == ["fake", "8"]


def test_new_modules_load_neither_jax_nor_repro():
    out = _python("import sys, repro_torch.distributed.sharding, "
                  "repro_torch.launch.mesh, repro_torch.launch.dryrun; "
                  "print(sorted(m for m in sys.modules if m in ('jax', "
                  "'repro') or m.startswith(('jax.', 'repro.'))))")
    assert out.strip() == "[]"


def test_collective_stats_names_and_sums():
    from repro_torch.launch.dryrun import collective_stats

    got = collective_stats([("all_gather_into_tensor", 64),
                            ("all_reduce", 8), ("all_reduce", 8),
                            ("reduce_scatter_tensor", 4),
                            ("all_to_all_single", 2), ("wait_tensor", 99)])
    assert got["bytes_by_op"] == {"all-gather": 64, "all-reduce": 16,
                                  "reduce-scatter": 4, "all-to-all": 2,
                                  "collective-permute": 0}
    assert got["counts"]["all-reduce"] == 2
    assert got["total_bytes"] == 86
    assert math.isclose(sum(got["bytes_by_op"].values()), 86)
