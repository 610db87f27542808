"""Production mesh builders on ``torch.distributed``.

Defined as FUNCTIONS (not module-level constants) so importing this module
never touches a process group: the dry run starts its own world of 512
ranks of the ``"fake"`` backend before it builds a production mesh; tests
and examples build a one-rank host mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve_device


def _device_type() -> str:
    """The default group's device type: ``cuda`` under NCCL, else ``cpu``
    (``gloo`` and the dry run's ``fake`` backend)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 (data, model) over ranks 0–255 or 2x16x16 (pod, data, model)
    over ranks 0–511 of the current process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if dist.get_world_size() < n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """Degenerate 1x1 (data, model) mesh over a world of one on ``device``
    (None = the card, under NCCL; ``"cpu"`` under ``gloo``).  Starts that
    world when no process group exists."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError("the host mesh is a world of one; the process "
                         f"group has {dist.get_world_size()} ranks")
    return DeviceMesh(dev.type, [[0]], mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple:
    """Axis names that carry the batch (pod + data when present)."""
    names = mesh.mesh_dim_names
    return tuple(n for n in ("pod", "data") if n in names)


MESH_SPECS = {
    "single": dict(multi_pod=False, chips=256,
                   desc="16x16 (data, model): ranks 0-255"),
    "multi": dict(multi_pod=True, chips=512,
                  desc="2x16x16 (pod, data, model): ranks 0-511"),
}
