"""``run_scenario`` on the ``xlstm`` workload against the JAX package's:
the sync runtime and the batched fleet, held as
``test_torch_scenarios.py`` holds the mlp cells (a file of its own to
keep each file's JAX compile time short)."""
import pytest

pytest.importorskip("jax")

from test_torch_scenarios import check_against_reference  # noqa: E402


@pytest.mark.parametrize("scenario,runtime,engine", [
    ("uniform", "sync", None), ("flash_crowd", "fleet", "batched")])
def test_run_scenario_matches_reference(scenario, runtime, engine):
    check_against_reference(scenario, runtime, "xlstm", engine)
