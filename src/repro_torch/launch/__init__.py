"""The LM launchers: ``train`` (centralized and FedCore-for-LM training),
``serve`` (KV-cache generation), ``dryrun`` (the shape-only run of every
arch x shape x mesh) and the mesh builders below."""
from repro_torch.launch import mesh  # noqa: F401
from repro_torch.launch.mesh import (  # noqa: F401
    make_host_mesh,
    make_production_mesh,
)
