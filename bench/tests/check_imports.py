"""What the harness and the reference load: no module whose whole
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the port's
name, ``repro_torch``, begins with ``repro``), and the reference nothing
of the port either."""
import json
import subprocess
import sys

from bench.tests.common import ROOT

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib
for m in {mods!r}:
    importlib.import_module(m)
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""
REFERENCE = ["bench.reference.fleet", "bench.reference.fedcore_lm",
             "bench.reference.kmedoids", "bench.reference.llama",
             "bench.reference.smallcnn", "bench.inputs.mnist_like",
             "bench.inputs.specs", "bench.inputs.lm_stream",
             "bench.inputs.lm_init", "bench.roofline.counts"]
HARNESS = REFERENCE + ["bench.run", "bench.harness.trace",
                       "bench.drivers.fleet_round", "bench.drivers.fedcore_lm",
                       "repro_torch.fed.fleet", "repro_torch.launch.train"]


def loaded(mods):
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), mods=mods)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_any_repro_package():
    tops = loaded(REFERENCE)
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_harness_and_port_load_no_jax():
    tops = loaded(HARNESS)
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
