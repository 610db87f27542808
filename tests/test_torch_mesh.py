"""The port's mesh builders (``repro_torch.launch.mesh``): the two
production meshes on a fake world of 512 ranks, the one-rank host mesh
on the CPU (``gloo``) with a smoke model's params placed on it by
``param_specs``, ``data_axes``, and ``MESH_SPECS`` against the JAX
package's.  A process group is process-global, so each world starts in
a subprocess of its own (the tests run under xdist, where a group left
in a worker would break a later file that starts one)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]

_FAKE_WORLD = """
import json
from repro_torch.launch import dryrun, mesh
dryrun.force_world(512)
out = {}
for multi in (False, True):
    m = mesh.make_production_mesh(multi_pod=multi)
    out["multi" if multi else "single"] = {
        "shape": list(m.shape), "names": list(m.mesh_dim_names),
        "device_type": m.device_type, "data_axes": list(mesh.data_axes(m)),
        "ranks": m.mesh.flatten().tolist()[:3] + [int(m.mesh.max())]}
print(json.dumps(out))
"""

_SMALL_WORLD = """
import json
from repro_torch.launch import dryrun, mesh
dryrun.force_world(8)
try:
    mesh.make_production_mesh()
except ValueError as e:
    print(json.dumps({"error": str(e)}))
"""

_HOST_MESH = """
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_config
from repro_torch.distributed import param_specs
from repro_torch.distributed.sharding import spec_placements
from repro_torch.launch.mesh import data_axes, make_host_mesh
from repro_torch.models.model import Model

m = make_host_mesh(device="cpu")
cfg = get_config("zamba2-1.2b", smoke=True)
model = Model(cfg)
params = model.init(torch.Generator().manual_seed(0), device="cpu")
specs = param_specs(cfg, params, m, "tp")
local = {k: distribute_tensor(v, m, spec_placements(specs[k], m)).to_local()
         for k, v in params.items()}
tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                       generator=torch.Generator().manual_seed(1))
with torch.no_grad():
    want, _, _ = model.forward(params, {"tokens": tokens})
    got, _, _ = model.forward(local, {"tokens": tokens})
print(json.dumps({
    "shape": list(m.shape), "names": list(m.mesh_dim_names),
    "device_type": m.device_type, "backend": dist.get_backend(),
    "world": dist.get_world_size(), "data_axes": list(data_axes(m)),
    "sharded_specs": sum(any(a is not None for a in sp)
                         for sp in specs.values()),
    "shards_equal": all(torch.equal(local[k], params[k]) for k in params),
    "forward_equal": bool(torch.equal(got, want))}))
dist.destroy_process_group()
"""


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_DRYRUN_FORCE_DEVICES", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def production():
    return _run(_FAKE_WORLD)


@pytest.mark.parametrize("kind,shape,names", [
    ("single", [16, 16], ["data", "model"]),
    ("multi", [2, 16, 16], ["pod", "data", "model"]),
])
def test_production_mesh(production, kind, shape, names):
    got = production[kind]
    assert got["shape"] == shape and got["names"] == names
    assert got["device_type"] == "cpu"      # the fake backend's
    # ranks 0 .. n-1 of the world, row-major
    n = 256 if kind == "single" else 512
    assert got["ranks"] == [0, 1, 2, n - 1]
    assert got["data_axes"] == names[:-1]


def test_production_mesh_needs_its_ranks():
    assert "needs 256 ranks" in _run(_SMALL_WORLD)["error"]


def test_host_mesh_on_the_cpu():
    got = _run(_HOST_MESH)
    assert got["shape"] == [1, 1] and got["names"] == ["data", "model"]
    assert got["device_type"] == "cpu" and got["backend"] == "gloo"
    assert got["world"] == 1 and got["data_axes"] == ["data"]
    assert got["sharded_specs"] > 0
    assert got["shards_equal"] and got["forward_equal"]


def test_host_mesh_without_device_needs_cuda():
    """``device=None`` means the card, as every entry point of the port."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()


def test_mesh_specs_equal_reference():
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh

    assert list(tmesh.MESH_SPECS) == list(jmesh.MESH_SPECS)
    for kind, spec in jmesh.MESH_SPECS.items():
        got = tmesh.MESH_SPECS[kind]
        assert (got["multi_pod"], got["chips"]) == (spec["multi_pod"],
                                                    spec["chips"])
