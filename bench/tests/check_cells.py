"""Whole runs of every cell at a small size on the CPU, through
``bench/run.py``'s run with the card check skipped: a sound run prints
its result with every number compared, and each fault the cell's file
lists, planted in the program underneath, makes it not correct.  (The
limits are set from readings at the cells' own sizes on the card, where
sound runs are held to them: ``bench/calibrate.py``.)"""
import math

import pytest
import torch

from bench.tests.common import run_cell, spec

CELLS = spec.cell_names()
FAULTS = [(c, f) for c in CELLS for f in spec.load_cell(c)["faults"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_prints_its_result(cell):
    rc, result, err = run_cell(cell, seed=(1 << 31) + 11)
    assert rc == 0, err[-3000:]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(spec.load_cell(cell)["limits"])
    assert all(math.isfinite(c["value"]) for c in result["checks"].values())
    e2e = spec.cell_metrics(cell, spec.benchmark())["end_to_end"]
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_caught(cell, fault):
    rc, result, err = run_cell(cell, seed=(1 << 31) + 12, fault=fault)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]
