"""The port stands alone: no JAX, nothing of the JAX package, and no
silent CPU path.  Runs without JAX installed."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_importing_the_runtime_loads_no_jax():
    code = ("import sys, repro_torch.fed.server, repro_torch.kernels.ops, "
            "repro_torch.convert, repro_torch.fed.fleet; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_without_device_need_cuda():
    """``device=None`` means the card: without one, entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    from repro_torch.device import resolve_device
    from repro_torch.fed import LocalTrainer, make_eval_fn
    from repro_torch.models import SmallCNN

    model = SmallCNN(image_size=8, channels=(2, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalTrainer(model, 0.1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_fn(model, {"x": None, "y": None}, 4)
    from repro_torch.fed.fleet import FleetConfig, FleetEngine, run_fleet
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetEngine(model, FleetConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fleet(model, [], [], FleetConfig(), 1)
    assert resolve_device("cpu") == torch.device("cpu")
