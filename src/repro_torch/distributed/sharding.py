"""Sharding rules: map every param / input / decode-state leaf to a
``PartitionSpec`` for the production mesh, and a spec to DTensor
placements on a ``torch.distributed.device_mesh.DeviceMesh``.

Baseline layout ("tp"): tensor parallelism over the ``model`` axis, pure
data parallelism over ``pod``x``data`` (params replicated there).  The
"fsdp" mode additionally shards the params' other large dim over ``data``
(ZeRO-3 style).

Rules are matched on the key path of each leaf, most-specific first;
anything unmatched is replicated.  A flat parameter key such as
``enc_layers.0.attn.wq`` is read as the JAX package's tree path
``enc_layers/#0/attn/wq``, so the JAX package's rules apply word for word.
All rules respect divisibility: a dim is only sharded if the axis size
divides it (otherwise that dim falls back to replication, as for GQA caches
with kv_heads < model-axis size).
"""
from __future__ import annotations

import math
import re
from typing import Dict, List

from torch.distributed.tensor import Placement, Replicate, Shard

from repro_torch.configs.base import ModelConfig


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of axis names (the dim split over all of them, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_size(mesh, axis) -> int:
    """The size of ``axis`` (a name, a tuple of names or None) on a
    ``DeviceMesh`` (``mesh_dim_names`` and ``shape``) or on any mesh whose
    ``shape`` maps axis names to sizes."""
    if axis is None:
        return 1
    sizes = _axis_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _axis_sizes(mesh) -> Dict[str, int]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _fit(spec: P, shape, mesh) -> P:
    """Drop axis assignments whose size doesn't divide the dim."""
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axis is not None and dim % _axis_size(mesh, axis) == 0:
            out.append(axis)
        else:
            out.append(None)
    return P(*out)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

# (path regex, spec builder); specs are written for the *unstacked* trailing
# dims — stacked layer params get a leading None (``_is_stacked``).
def _param_rules(cfg: ModelConfig, fsdp: bool):
    d_ax = "data" if fsdp else None  # ZeRO dim
    return [
        # embeddings / unembedding: vocab over model
        (r"\bembed\b$", lambda s: P("model", d_ax)),
        (r"\bw_unembed\b$", lambda s: P(d_ax, "model")),
        # attention
        (r"attn.*\bwq\b$|attn.*\bwk\b$|attn.*\bwv\b$|xattn.*\bw[qkv]\b$",
         lambda s: P(d_ax, "model")),
        (r"attn.*\bwo\b$|xattn.*\bwo\b$", lambda s: P("model", d_ax)),
        # dense mlp
        (r"mlp.*\bw_gate\b$|mlp.*\bw_up\b$|shared.*\bw_gate\b$|"
         r"shared.*\bw_up\b$", lambda s: P(d_ax, "model")),
        (r"mlp.*\bw_down\b$|shared.*\bw_down\b$", lambda s: P("model", d_ax)),
        # MoE: experts over model (expert parallelism)
        (r"moe.*\bw_gate\b$|moe.*\bw_up\b$", lambda s: P("model", d_ax,
                                                         None)),
        (r"moe.*\bw_down\b$", lambda s: P("model", None, d_ax)),
        (r"moe.*\brouter\b$", lambda s: P(d_ax, None)),
        # mamba2: inner projections sharded on the wide dim
        (r"\bw_in\b$", lambda s: P(d_ax, "model")),
        (r"\bw_out\b$", lambda s: P("model", d_ax)),
        (r"\bconv_w\b$", lambda s: P(None, "model")),
        (r"\bconv_b\b$", lambda s: P("model")),
        # zamba shared concat projection
        (r"\bshared_in\b$", lambda s: P(d_ax, "model")),
        # xlstm
        (r"\bwq\b$|\bwk\b$|\bwv\b$|\bwo_gate\b$", lambda s: P(d_ax, "model")),
        (r"\br\b$", lambda s: P(None, "model", None, None)),
    ]


def _path_key(flat_key: str) -> str:
    """``enc_layers.0.attn.wq`` -> ``enc_layers/#0/attn/wq``: the JAX
    package's tree path of a flat parameter key."""
    return "/".join(f"#{part}" if part.isdigit() else part
                    for part in flat_key.split("."))


def param_specs(cfg: ModelConfig, params_shapes, mesh, mode: str = "tp"):
    """params_shapes: the flat parameter dict (tensors of any device, the
    meta device or a ``FakeTensorMode`` included) -> {key: spec}."""
    rules = _param_rules(cfg, fsdp=(mode == "fsdp"))
    specs = {}
    for name, leaf in params_shapes.items():
        key = _path_key(name)
        spec = P()
        for pattern, builder in rules:
            if re.search(pattern, key):
                raw = builder(leaf.shape)
                # stacked-layer params: shift spec right past the L dim
                if _is_stacked(key, leaf.shape, raw):
                    raw = P(None, *tuple(raw))
                spec = _fit(raw, leaf.shape, mesh)
                break
        specs[name] = spec
    return specs


def _is_stacked(key: str, shape, raw: P) -> bool:
    """Heuristic: stacked layer params carry a leading L dim."""
    return ("layers" in key and len(shape) == len(tuple(raw)) + 1)


# ---------------------------------------------------------------------------
# batch / decode-state rules
# ---------------------------------------------------------------------------

def shard_batch_axes(mesh) -> tuple:
    names = _axis_sizes(mesh)
    return tuple(n for n in ("pod", "data") if n in names)


def batch_specs(batch_shapes, mesh):
    """Shard the leading batch dim over (pod, data) when divisible."""
    axes = shard_batch_axes(mesh)

    def one(leaf):
        if leaf.ndim == 0:
            return P()
        return _fit(P(axes), leaf.shape, mesh)

    return {k: one(v) for k, v in batch_shapes.items()}


def decode_state_specs(cfg: ModelConfig, state_shapes, mesh,
                       context_parallel: bool = False):
    """KV caches: batch over (pod, data); kv-heads over model when they
    divide; with ``context_parallel=True`` the cache *sequence* dim is
    sharded over model instead (for GQA archs whose kv_heads < |model|).

    ``state_shapes`` is ``Model.init_decode_state``'s nested dicts, lists
    and named tuples (``MambaState``, the xLSTM block states); the result
    has the same structure, each tensor replaced by its spec.  Keys are
    the JAX package's paths: ``kv/k``, ``mamba/.ssm``, ``enc_k``,
    ``blocks/#0/.C``.
    """
    axes = shard_batch_axes(mesh)

    def one(key, leaf):
        shape = leaf.shape
        if "kv" in key and leaf.ndim == 5:      # (L, B, S, Hk, hd)
            if context_parallel:
                spec = P(None, axes, "model", None, None)
            else:
                spec = P(None, axes, None, "model", None)
            return _fit(spec, shape, mesh)
        if "enc_" in key and leaf.ndim == 4:    # (L, B, S_enc, Hk, hd)? 4/5d
            return _fit(P(None, axes, None, None, None), shape, mesh)
        if "mamba" in key and leaf.ndim >= 3:   # (L, B, nh, hd, n) / conv
            if leaf.ndim == 5:
                return _fit(P(None, axes, "model", None, None), shape, mesh)
            return _fit(P(None, axes, None, "model"), shape, mesh)
        if leaf.ndim >= 2:                      # xlstm block states (B, H,..)
            return _fit(P(axes, "model"), shape, mesh)
        return _fit(P(axes), shape, mesh)

    return map_with_path(one, state_shapes)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(key, leaf)`` on every leaf (a ``PartitionSpec`` is one) of
    nested dicts, lists, tuples and named tuples, keyed as the JAX
    package's ``"/".join`` of a tree path (``name``, ``#i``,
    ``.field``); the same structure back."""
    def join(part):
        return f"{prefix}/{part}" if prefix else part

    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, join(str(k)))
                for k, v in tree.items()}
    if isinstance(tree, PartitionSpec):
        return fn(prefix, tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, join(f".{f}"))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, join(f"#{i}"))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------

def spec_placements(spec: P, mesh) -> List[Placement]:
    """One placement per mesh dim: ``Shard(d)`` on each mesh dim that
    ``spec`` names for tensor dim d, ``Replicate()`` elsewhere.  A tuple
    ``("pod", "data")`` on one tensor dim shards it on both mesh dims, pod
    major, as the JAX package orders them; its names must come in the
    mesh's order."""
    names = list(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate()] * len(names)
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        group = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"axes {group} are not in the mesh's order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape(shape, spec: P, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor laid out by
    ``spec`` (a fitted spec: every named axis divides its dim)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(dim // _axis_size(mesh, axis)
                 for dim, axis in zip(shape, spec))

