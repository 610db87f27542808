"""Collectives of the port: cross-silo FedAvg and the sharded fleet
engine's weighted reduction, on ``torch.distributed``."""
from repro_torch.distributed.fedavg_mesh import (  # noqa: F401
    fedavg_allreduce,
    weighted_psum_sum,
)
