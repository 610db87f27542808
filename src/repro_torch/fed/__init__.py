"""The synchronous FL runtime (Alg. 1) in PyTorch."""
from repro_torch.fed.cost import (  # noqa: F401  (leaf module: import first)
    FORWARD_FRAC,
    UNIT_COST,
    CostPlan,
    WorkloadCostModel,
    resolve_cost,
)
from repro_torch.fed.aggregators import (  # noqa: F401
    SyncWeightedMean,
    weighted_mean_params,
)
from repro_torch.fed.server import (  # noqa: F401
    FLConfig,
    RoundRecord,
    make_eval_fn,
    run_federated,
    sample_clients,
    summarize,
)
from repro_torch.fed.simulator import (  # noqa: F401
    CapabilityTrace,
    ClientSpec,
    TraceConfig,
    make_client_specs,
    sample_capabilities,
    straggler_deadline,
    straggler_mask,
)
from repro_torch.fed.strategies import (  # noqa: F401
    ClientResult,
    FedAvg,
    FedAvgDS,
    FedCore,
    FedProx,
    LocalTrainer,
    Strategy,
)
