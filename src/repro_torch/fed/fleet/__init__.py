"""The fleet runtime: cohort groups run batched (vmap over the client
axis) or one client at a time, on the port's fleet workloads."""
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
from repro_torch.fed.fleet.scheduler import (  # noqa: F401
    AdaptiveParticipation,
    ParticipationConfig,
)
from repro_torch.fed.fleet.workloads import (  # noqa: F401
    WORKLOADS,
    ArraySpec,
    FleetWorkload,
    client_num_samples,
    client_sizes,
    get_workload,
)
