"""The port stands alone: no JAX, nothing of the JAX package, and no
silent CPU path.  Runs without JAX installed."""
import ast
import functools
import json
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
            "repro_torch.convert, repro_torch.fed.fleet, "
            "repro_torch.fed.fleet.sharded, repro_torch.distributed, "
            "repro_torch.models.attention, repro_torch.configs; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_importing_the_lm_path_loads_no_jax():
    """The dense LM path: the model, the configs (all ten), the
    optimisers and schedules, the train step and both launchers."""
    code = ("import sys, repro_torch.models.model, repro_torch.configs, "
            "repro_torch.optim, repro_torch.optim.schedules, "
            "repro_torch.models.training, repro_torch.launch.train, "
            "repro_torch.launch.serve, repro_torch.utils; "
            "[repro_torch.configs.get_config(a) for a in "
            "repro_torch.configs.ARCH_IDS]; "
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_importing_the_async_fleet_engine_loads_no_jax():
    code = ("import sys, repro_torch.fed.fleet.async_engine; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# public names of the JAX package's that belong to open ROADMAP items:
# none since the mesh sharding helpers of ``repro.distributed`` and their
# module were ported (item 17)
OPEN_ITEM_NAMES = {"fed": set(), "fed.fleet": set(), "distributed": set()}


@pytest.mark.parametrize("package", sorted(OPEN_ITEM_NAMES))
def test_public_names_equal_reference(package):
    """``repro_torch.<package>`` exports every public name of
    ``repro.<package>`` but those of open items; the port's only extra
    is ``nominal_budgets``, a helper of its fleet tests."""
    pytest.importorskip("jax")
    import importlib

    def public(name):
        mod = importlib.import_module(name)
        return {n for n in dir(mod) if not n.startswith("_")}

    want = public(f"repro.{package}")
    got = public(f"repro_torch.{package}")
    assert OPEN_ITEM_NAMES[package] <= want
    assert want - OPEN_ITEM_NAMES[package] - got == set()
    assert got - want <= {"nominal_budgets"}


def test_strategies_registry_equals_reference():
    pytest.importorskip("jax")
    import repro.fed as jfed
    import repro_torch.fed as tfed
    import repro_torch.fed.strategies as tstrat

    assert list(tfed.STRATEGIES) == list(jfed.STRATEGIES)
    for key, cls in tfed.STRATEGIES.items():
        assert cls is getattr(tstrat, jfed.STRATEGIES[key].__name__)
        assert issubclass(cls, tstrat.Strategy)


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
    from repro_torch.fed import (AsyncFLConfig, FedCore, LocalTrainer,
                                 run_federated_async)
    strategy = FedCore(LocalTrainer(model, 0.1, 4, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federated_async(model, [], [], strategy, AsyncFLConfig())
    from repro_torch.fed.fleet import FleetConfig, FleetEngine, run_fleet
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetEngine(model, FleetConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fleet(model, [], [], FleetConfig(), 1)
    from repro_torch.fed import ClientSpec
    from repro_torch.fed.fleet import AsyncFleetConfig, run_async_fleet
    with pytest.raises(RuntimeError, match="CUDA"):
        run_async_fleet(model, [{}], [ClientSpec(0, 4, 1.0)],
                        AsyncFleetConfig())
    assert resolve_device("cpu") == torch.device("cpu")


# the LM path's packages: public names of the JAX package's that belong
# to open ROADMAP items, read in a fresh interpreter after importing the
# package alone (so no other test's imports add submodules): none since
# the launchers' mesh helpers and dry run were ported (item 17)
LM_OPEN_ITEM_NAMES = {"models": set(), "optim": set(),
                      "utils": set(), "configs": set(), "launch": set()}
# the public names a reference module defines that belong to open items:
# none since item 17
LM_OPEN_MODULE_NAMES = {}
LM_MODULES = ("models.model", "models.attention", "models.layers",
              "models.training", "models.xlstm", "models.moe",
              "models.mamba2", "optim.optimizers",
              "optim.schedules", "utils.tree", "configs.base",
              "launch.train", "launch.serve", "launch.mesh",
              "launch.dryrun", "distributed.sharding")


@functools.lru_cache(maxsize=None)
def _lm_public_names(root: str) -> dict:
    """{name: public names} of ``root``'s LM packages and modules, read in
    one fresh interpreter: each package's names right after importing it
    (so no other test's imports add submodules), then for each module the
    functions and classes it defines and its upper-case constants."""
    code = ("import importlib, json; out = {}\n"
            f"for name in {sorted(LM_OPEN_ITEM_NAMES)!r}:\n"
            f"    m = importlib.import_module({root!r} + '.' + name)\n"
            "    out[name] = sorted(n for n in dir(m) if n[0] != '_')\n"
            f"for name in {LM_MODULES!r}:\n"
            f"    m = importlib.import_module({root!r} + '.' + name)\n"
            "    out[name] = sorted(\n"
            "        n for n in dir(m) if n[0] != '_' and (n.isupper() or\n"
            "        getattr(getattr(m, n), '__module__', None)\n"
            "        == m.__name__))\n"
            "print(json.dumps(out))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return {k: set(v) for k, v in json.loads(out.stdout).items()}


@pytest.mark.parametrize("package", sorted(LM_OPEN_ITEM_NAMES))
def test_lm_package_public_names_equal_reference(package):
    """``repro_torch.<package>`` exports every public name of
    ``repro.<package>`` but those of open items, and nothing else."""
    pytest.importorskip("jax")
    want = _lm_public_names("repro")[package]
    got = _lm_public_names("repro_torch")[package]
    assert LM_OPEN_ITEM_NAMES[package] <= want
    assert want - LM_OPEN_ITEM_NAMES[package] == got


@pytest.mark.parametrize("module", LM_MODULES)
def test_lm_module_defines_the_reference_names(module):
    """Each function, class and constant a reference module of the LM
    path defines is defined by the port's module, open items aside."""
    pytest.importorskip("jax")
    want = _lm_public_names("repro")[module]
    got = _lm_public_names("repro_torch")[module]
    assert want - LM_OPEN_MODULE_NAMES.get(module, set()) <= got, \
        want - got
