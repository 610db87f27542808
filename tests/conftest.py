import os

# Tests run on the single host CPU device (the dry-run, and ONLY the dry-run,
# forces 512 host devices via XLA_FLAGS in launch/dryrun.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
from typing import Any, List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels of the "
        "PyTorch port); skips where torch.cuda.is_available() is false")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# shared fleet test workloads
#
# One builder replaces the synthetic-client constructions that used to be
# copy-pasted across test_fleet.py, test_fleet_sharded.py, and
# test_kmedoids_fused.py, and parameterizes them by FleetWorkload so the
# conformance matrix runs the same construction for mlp / cnn / charlm /
# xlstm.  Plain functions (not only fixtures) on purpose: the sharded
# parity test re-execs itself as a multi-device subprocess and imports
# ``conftest`` directly.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetBundle:
    """A ready-to-run fleet test workload: model + split data + specs."""
    workload: Any                 # FleetWorkload (usable as the model)
    train: List[Any]
    test: Any
    specs: List[Any]
    trace: Optional[Any] = None   # TraceConfig when built from a scenario

    @property
    def model(self):
        return self.workload


def fleet_bundle(workload: str = "mlp", n_clients: int = 16, seed: int = 3,
                 mean_samples: float = 60.0, std_samples: float = 40.0,
                 test_frac: float = 0.1,
                 scenario: Optional[str] = None) -> FleetBundle:
    """Build a federated test fleet for any registered workload.

    ``scenario=None`` draws client capabilities with ``make_client_specs``
    (seeded by ``seed``); a scenario name draws them from the registry via
    ``build_scenario`` and also returns the scenario's TraceConfig.
    """
    from repro.data.partition import train_test_split_clients
    from repro.fed.fleet.scenarios import build_scenario
    from repro.fed.fleet.workloads import client_sizes, get_workload
    from repro.fed.simulator import make_client_specs

    wl = get_workload(workload)
    clients = wl.make_clients(n_clients=n_clients, seed=seed,
                              mean_samples=mean_samples,
                              std_samples=std_samples)
    wl.validate_clients(clients)
    train, test = train_test_split_clients(clients, test_frac=test_frac)
    sizes = client_sizes(train)
    trace = None
    if scenario is not None:
        specs, trace = build_scenario(scenario, sizes, seed)
    else:
        specs = make_client_specs(sizes, np.random.default_rng(seed))
    return FleetBundle(workload=wl, train=train, test=test, specs=specs,
                       trace=trace)


def fixed_size_clients(workload: str = "mlp", n_clients: int = 6,
                       m: int = 40, seed: int = 0):
    """Same-size clients (exactly ``m`` samples each), so one budget maps
    to one cohort group — what the kernel/dispatch-count tests rely on.
    Returns ``(FleetWorkload, clients_data)``."""
    import jax

    from repro.fed.fleet.workloads import client_num_samples, get_workload

    wl = get_workload(workload)
    # oversample (tiny spread keeps every draw >= 2m), then slice to m
    clients = wl.make_clients(n_clients=n_clients, seed=seed,
                              mean_samples=float(2 * m), std_samples=0.1)
    clients = [jax.tree.map(lambda v: v[:m], d) for d in clients]
    assert all(client_num_samples(d) == m for d in clients)
    return wl, clients


@pytest.fixture(scope="session")
def fleet_bundles():
    """Session-cached ``fleet_bundle`` factory: identical kwargs return
    the same bundle object, so parametrized matrices don't rebuild (or
    re-split) a workload's dataset per test."""
    cache = {}

    def get(**kwargs) -> FleetBundle:
        key = tuple(sorted(kwargs.items()))
        if key not in cache:
            cache[key] = fleet_bundle(**kwargs)
        return cache[key]

    return get
