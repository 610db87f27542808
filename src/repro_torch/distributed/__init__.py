"""Distribution of the port on ``torch.distributed``: the mesh sharding
rules (``sharding``), cross-silo FedAvg and the sharded fleet engine's
weighted reduction."""
from repro_torch.distributed import sharding  # noqa: F401
from repro_torch.distributed.sharding import (  # noqa: F401
    batch_specs,
    decode_state_specs,
    param_specs,
    shard_batch_axes,
)
from repro_torch.distributed.fedavg_mesh import (  # noqa: F401
    fedavg_allreduce,
    weighted_psum_sum,
)
