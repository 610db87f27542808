"""Mesh-sharded fleet engine: cohort groups data-parallel over ranks.

The batched engine (``repro_torch.fed.fleet.batched``) runs a round as a
handful of vmapped group bodies, every one of them on one device.  This
module splits the *client axis* of each ``CohortGroup`` across the ranks
of a 1-D ``torch.distributed`` device mesh: local SGD, gradient features
and masked k-medoids (the distance-free kernels at M >= the cutover, the
batched pairwise kernel and the D-input kernels below it) run on
``C / n_ranks`` client lanes a rank, and the group's weighted parameter
sum is one all-reduce.

The JAX package does this with ``shard_map``, a single controller over
the mesh.  The torch idiom is SPMD by process, one process a rank, as
``torchrun`` starts them: every rank runs the same driver, and cohorts,
budgets, the scheduler and the fault draws are pure functions of the
seed, so the ranks agree on them without a message.

Execution contract (what makes sharding a pure performance choice):

  * the per-client arithmetic is literally the batched engine's: a rank
    runs ``FleetEngine._run_group_stacked`` on its lanes, so loop, batched
    and sharded share one copy of the arithmetic.  Selection solves each
    lane on its own, so medoids equal the batched engine's; aggregated
    params agree to float32 summation-order tolerance (local partial sums
    and an all-reduce against one tensordot);
  * a group is padded on the host to a multiple of the rank count by
    repeating its last lane with **zero aggregation weight**, so padding
    never perturbs the weighted mean; rank r takes the contiguous block
    of lanes ``[r·C/n, (r+1)·C/n)``, the block ``NamedSharding(P(
    "clients"))`` places on device r in the reference;
  * the weighted reduction is ``repro_torch.distributed.weighted_psum_sum``
    (one all-reduce of a flat buffer, the same bits on every rank); the
    small per-client losses and medoids are gathered to every rank and
    the padding lanes cut off; the per-client parameter stack is gathered
    only when a robust rule or Byzantine corruption consumes it.

``run_fleet(engine="sharded")`` and ``run_async_fleet(engine="sharded")``
build this engine when a process group of more than one rank exists;
without one they run the batched engine and record ``engine_mode:
"batched"``, as the reference does on one device.  On a card, start the
ranks with ``torchrun --nproc_per_node=N``; each takes ``cuda:<LOCAL_RANK>``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.fedavg_mesh import weighted_psum_sum
from repro_torch.fed.fleet.batched import CohortGroup, FleetConfig, FleetEngine
from repro_torch.obs import get_recorder

Params = Dict[str, torch.Tensor]

CLIENT_AXIS = "clients"


def world_size() -> int:
    """Ranks of the default process group; 1 when there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``device``, else ``cuda:<LOCAL_RANK>``."""
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return resolve_device(device)


def client_mesh(n_devices: Optional[int] = None,
                devices: Optional[Sequence[DeviceLike]] = None
                ) -> DeviceMesh:
    """A 1-D mesh named ``"clients"`` over every rank of the default
    process group.  ``devices[r]`` is rank r's device (default
    ``cuda:<LOCAL_RANK>`` on every rank).  ``n_devices``, if given, must
    equal the world size: a sub-mesh would leave ranks without work."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "client_mesh needs the default process group: call "
            "torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"client_mesh over {n_devices} devices, but the "
                         f"process group has {world} ranks")
    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    dev = rank_device(None if devices is None else devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DeviceMesh(dev.type, list(range(world)),
                      mesh_dim_names=(CLIENT_AXIS,))


def _pad_lanes(v: np.ndarray, pad: int) -> np.ndarray:
    """Pad the leading client dim by repeating the last lane."""
    if pad == 0:
        return v
    return np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])


class ShardedFleetEngine(FleetEngine):
    """A ``FleetEngine`` whose groups run sharded over a client mesh.

    ``run_group_sharded`` runs one cohort group data-parallel over the
    ``"clients"`` mesh dim and returns the group's *weighted parameter
    sum*, already all-reduced, so the server's mean is one divide at the
    end of the round (``combine_group_sums``).  The inherited
    ``run_group`` (batched / loop) still works on the rank's device.
    ``device`` is this rank's device (default ``cuda:<LOCAL_RANK>``), and
    ``mesh`` defaults to ``client_mesh`` over every rank."""

    def __init__(self, model, cfg: FleetConfig,
                 mesh: Optional[DeviceMesh] = None,
                 device: DeviceLike = None):
        dev = rank_device(device)
        super().__init__(model, cfg, device=dev)
        self.mesh = (mesh if mesh is not None
                     else client_mesh(devices=[dev] * world_size()))
        if self.mesh.device_type != dev.type:
            raise ValueError(f"a {self.mesh.device_type} mesh for a rank "
                             f"on {dev}")
        self.n_devices = self.mesh.size()
        self.rank = self.mesh.get_local_rank(CLIENT_AXIS)
        self.group = self.mesh.get_group(CLIENT_AXIS)
        # gloo cannot all-gather CUDA tensors: there the gathers go
        # through the host (the all-reduce takes CUDA tensors either way)
        self._gather_device = (dev if dist.get_backend(self.group) == "nccl"
                               else torch.device("cpu"))

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's (L, ...) block of ``x`` in rank order, on x's
        device."""
        xg = x.to(self._gather_device).contiguous()
        parts = [torch.empty_like(xg) for _ in range(self.n_devices)]
        dist.all_gather(parts, xg, group=self.group)
        return torch.cat(parts).to(x.device)

    def _local_group(self, group: CohortGroup, pad: int) -> CohortGroup:
        """This rank's contiguous block of the padded group's lanes."""
        per = (group.n_clients + pad) // self.n_devices
        lanes = slice(self.rank * per, (self.rank + 1) * per)

        def mine(v):
            return _pad_lanes(np.asarray(v), pad)[lanes]

        return CohortGroup(cids=mine(group.cids),
                           data={f: mine(v) for f, v in group.data.items()},
                           valid=mine(group.valid), m=mine(group.m),
                           k=group.k, perms=mine(group.perms))

    def run_group_sharded(self, params: Params, group: CohortGroup,
                          weights, gather_stack: bool = False
                          ) -> Tuple[Params, torch.Tensor, np.ndarray,
                                     Optional[np.ndarray], Optional[Params]]:
        """Run one group over the mesh; returns (weighted param sum,
        weight total, per-client losses, medoid indices or None, the
        per-client param stack or None), with the padding lanes cut off.
        The stack is gathered to every rank only with ``gather_stack``
        (a robust rule or Byzantine corruption needs it); the weighted
        mean uses the all-reduced sum and never moves it.  The group
        counts one dispatch, as on the batched engine.  The ``allreduce``
        span times the group's collectives, the wait for the slowest rank
        included."""
        c = group.n_clients
        pad = (-c) % self.n_devices
        local = self._local_group(group, pad)
        per = local.n_clients
        lane_w = np.concatenate([np.asarray(weights, np.float32),
                                 np.zeros(pad, np.float32)])
        lane_w = lane_w[self.rank * per:(self.rank + 1) * per]
        p, losses, meds = self._run_group_stacked(params, local,
                                                  n_clients=c, sharded=True)
        with get_recorder().span("allreduce", k=group.k, n_clients=c,
                                 sharded=True):
            part, wsum = weighted_psum_sum(lane_w, p, self.group)
            cols = [torch.as_tensor(losses, dtype=torch.float64)[:, None]]
            if meds is not None:
                cols.append(torch.as_tensor(meds, dtype=torch.float64))
            got = self._all_gather(torch.cat(cols, dim=1))[:c].numpy()
            stack = ({k: self._all_gather(v)[:c] for k, v in p.items()}
                     if gather_stack else None)
        return (part, wsum, got[:, 0].astype(losses.dtype),
                None if meds is None else got[:, 1:].astype(meds.dtype),
                stack)

    def combine_group_sums(self, partials: List[Tuple[Params, torch.Tensor]],
                           fallback: Params) -> Params:
        """Σ_g (weighted param sum) / Σ_g (weight total).

        Groups are added in the sorted-key order ``make_cohort_groups``
        emits, so the reduction is order-stable, and divided once.  An
        empty cohort (or all-zero weights) returns ``fallback``, as
        ``_aggregate_groups`` does."""
        if not partials:
            return fallback
        acc, total = partials[0]
        for part, wsum in partials[1:]:
            acc = {k: acc[k] + part[k] for k in acc}
            total = total + wsum
        if float(total) <= 0.0:
            return fallback
        return {k: v / total for k, v in acc.items()}
