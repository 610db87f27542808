"""The fleet runtime: cohort groups run batched (vmap over the client
axis), sharded over the ranks of a process group, or one client at a
time, on the port's fleet workloads; the named
heterogeneity scenarios that drive the sync, async, fleet and async
fleet runtimes; the event-driven async fleet engine and its merge rules;
and the fault axis."""
from repro_torch.fed.fleet.async_engine import (  # noqa: F401
    ASYNC_MERGES,
    AsyncFleetConfig,
    AsyncMergeRule,
    DelayedGradientMerge,
    FedAsyncMerge,
    FedBuffMerge,
    RobustMerge,
    as_merge_rule,
    run_async_fleet,
)
from repro_torch.fed.fleet.faults import (  # noqa: F401
    FAULT_PROFILES,
    FaultProfile,
    FaultTrace,
    corrupt_stacked,
    corrupt_update,
    dirichlet_label_skew,
    get_fault_profile,
)
from repro_torch.fed.fleet.batched import (  # noqa: F401
    CohortGroup,
    FleetConfig,
    FleetEngine,
    FleetRoundStats,
    make_cohort_groups,
    nominal_budgets,
    run_fleet,
    run_fleet_round,
    weighted_param_sum,
)
from repro_torch.fed.fleet.scenarios import (  # noqa: F401
    SCENARIOS,
    Scenario,
    build_scenario,
    run_scenario,
)
from repro_torch.fed.fleet.scheduler import (  # noqa: F401
    AdaptiveParticipation,
    ParticipationConfig,
)
from repro_torch.fed.fleet.sharded import (  # noqa: F401
    ShardedFleetEngine,
    client_mesh,
)
from repro_torch.fed.fleet.workloads import (  # noqa: F401
    WORKLOADS,
    ArraySpec,
    CharXLSTM,
    FleetWorkload,
    client_num_samples,
    client_sizes,
    get_workload,
)
