"""The FL runtimes in PyTorch: the synchronous round server (Alg. 1), the
event-driven async runtime, their aggregators and the fault axis."""
from repro_torch.fed.cost import (  # noqa: F401  (leaf module: import first)
    FORWARD_FRAC,
    UNIT_COST,
    CostPlan,
    WorkloadCostModel,
    resolve_cost,
    workload_cost_model,
)
from repro_torch.fed.aggregators import (  # noqa: F401
    AGGREGATORS,
    ROBUST_METHODS,
    Aggregator,
    ClientUpdate,
    DelayedGradient,
    FedAsync,
    FedBuff,
    RobustAggregate,
    SyncWeightedMean,
    polynomial_staleness,
    robust_combine,
    stack_params,
    weighted_mean_params,
)
from repro_torch.fed.events import (  # noqa: F401
    AsyncFLConfig,
    Event,
    EventQueue,
    run_federated_async,
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
    STRATEGIES,
    ClientResult,
    FedAvg,
    FedAvgDS,
    FedCore,
    FedProx,
    LocalTrainer,
    Strategy,
)

# the fleet subpackage imports the server and simulator, so this stays the
# last import of this module
from repro_torch.fed.fleet import (  # noqa: E402,F401
    FAULT_PROFILES,
    SCENARIOS,
    AdaptiveParticipation,
    FaultProfile,
    FaultTrace,
    FleetConfig,
    FleetEngine,
    ParticipationConfig,
    build_scenario,
    dirichlet_label_skew,
    get_fault_profile,
    run_fleet,
    run_scenario,
)
