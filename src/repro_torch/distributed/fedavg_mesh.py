"""Cross-silo FedAvg as ``torch.distributed`` collectives.

FL clients are silos held by the ranks of a ``DeviceMesh``: each rank
holds the params of its own silos, a leading silo dim on every leaf.
Server aggregation w <- (Σ wᵢ·pᵢ)/(Σ wᵢ) is then not an RPC but a
weighted sum over the local silos followed by an all-reduce over the
mesh's client dims, one dim after another: within a pod first, then
across pods, the hierarchical FedAvg that the mesh's factorization gives.

The JAX package writes the same reduction as a ``psum`` inside a
``shard_map`` (a single controller over the mesh); here every rank runs
the same program on its own silos (SPMD by process, as ``torchrun``
starts them), and the all-reduce leaves the same bits on every rank.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Groups = Union[None, dist.ProcessGroup, Sequence[dist.ProcessGroup]]


def _groups(group: Groups):
    """``None`` (the default group), one group or a sequence of them."""
    if group is None or isinstance(group, dist.ProcessGroup):
        return [group]
    return list(group)


def weighted_psum_sum(weights, stacked: Mapping[str, torch.Tensor],
                      group: Groups = None
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Weighted sum over the local client lanes, all-reduced over ``group``.

    ``stacked`` maps names to tensors with a leading local-client dim
    matching ``weights`` (local_clients,); each leaf's weighted sum over
    that dim is taken on the rank (one ``tensordot``), then the leaves and
    the weight total are summed across the ranks of ``group`` (a process
    group, a sequence of them reduced one after another, or None for the
    default group) in ONE all-reduce of a flat buffer.  Returns ``(summed
    leaves without the client dim, total weight)``, the same bits on every
    rank.  Shared by ``fedavg_allreduce`` and the sharded fleet engine
    (``repro_torch.fed.fleet.sharded``)."""
    first = next(iter(stacked.values()))
    w = torch.as_tensor(weights, dtype=torch.float32, device=first.device)
    sums = {k: torch.tensordot(w, x.float(), dims=([0], [0]))
            for k, x in stacked.items()}
    flat = torch.cat([v.reshape(-1) for v in sums.values()]
                     + [w.sum().reshape(1)])
    for g in _groups(group):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=g)
    out, i = {}, 0
    for k, v in sums.items():
        out[k] = flat[i:i + v.numel()].view(v.shape)
        i += v.numel()
    return out, flat[i]


def fedavg_allreduce(local_params: Mapping[str, torch.Tensor], weights,
                     mesh, client_axes: Tuple[str, ...] = ("pod", "data")
                     ) -> Dict[str, torch.Tensor]:
    """Weighted FedAvg across the client dims of ``mesh``.

    ``local_params``: this rank's silos, each leaf (silos_on_rank, ...);
    ``weights``: their (silos_on_rank,) aggregation weights (mⁱ, or ones
    for the uniform 1/K).  The reduction runs over those of
    ``client_axes`` that the mesh names, one dim after another; ranks
    along the mesh's other dims hold replicas and are not summed.
    Returns the aggregated params without the silo dim, the same on every
    rank."""
    axes = [a for a in client_axes if a in (mesh.mesh_dim_names or ())]
    summed, total = weighted_psum_sum(
        weights, local_params, [mesh.get_group(a) for a in axes])
    return {k: v / total for k, v in summed.items()}
