"""``run_scenario`` on the ``xlstm`` workload against the JAX package's:
the sync runtime and the batched fleet, held as
``test_torch_scenarios.py`` holds the mlp cells, the tied
``device_classes`` fleet cell by its first-round k-medoids objectives (a
file of its own to keep each file's JAX compile time short)."""
import pytest

pytest.importorskip("jax")

from test_torch_scenarios import (  # noqa: E402
    check_against_reference, check_tied_against_reference)


@pytest.mark.parametrize("scenario,runtime,engine", [
    ("uniform", "sync", None), ("flash_crowd", "fleet", "batched")])
def test_run_scenario_matches_reference(scenario, runtime, engine):
    check_against_reference(scenario, runtime, "xlstm", engine)


def test_tied_fleet_cell_matches_reference_by_objective(monkeypatch):
    check_tied_against_reference("device_classes", "xlstm", monkeypatch)
