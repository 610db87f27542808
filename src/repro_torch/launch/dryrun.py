"""Multi-pod dry run, shape only: prove the distribution config is
coherent without the hardware.

For every (architecture x input-shape x mesh) combination this traces the
real step function — the train step for train shapes, the forward for
prefill, one ``decode_step`` (one token against a full-length KV/SSM
cache) for decode shapes — with the production sharding rules, on
DTensors whose local shards are meta tensors: one rank's view of a world
of 512 ranks of the ``"fake"`` backend, all in this process.  No tensor
holds data and nothing runs on a device.  It records:

  * ``memory``: one rank's argument, output and temp bytes (temps are the
    peak of the live local bytes the step makes) and their sum
    ``bytes_per_device``;
  * ``cost``: ``flops`` of the local ops one rank runs;
  * ``collectives``: bytes (output shapes) and counts of the collectives
    the step issues, under the JAX package's five names.

Where the JAX package lowers and compiles with XLA, this traces eagerly,
so ``trace_s`` replaces its ``lower_s`` and ``compile_s``, and every
layer's collectives are counted (an HLO loop body counts once there).
The CPU mesh of the fake world runs an all-to-all as all-gather + chunk,
which counts as all-gather.  Decode stands in ``seq_len - 1`` as a
Python int for the position the JAX package traces: the port's
``attention_decode`` takes ``int(pos)``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
      --out results/dryrun.jsonl
A failure here (a sharding mismatch, an op with no sharding strategy) is
a bug in the system, not in the harness.
"""
import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.distributed.sharding import (
    P, _axis_size, _fit, batch_specs, decode_state_specs, local_shape,
    map_with_path, param_specs, shard_batch_axes, spec_placements)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention, mamba2, moe, xlstm
from repro_torch.models import model as model_module
from repro_torch.models.layers import mlp, subparams
from repro_torch.models.model import IGNORE, Model
from repro_torch.optim.optimizers import adam, sgd
from repro_torch.utils.tree import tree_add

DTYPE = torch.bfloat16


def force_world(n: int) -> None:
    """Start a process group of ``n`` ranks of the ``"fake"`` backend in
    this process (this process is rank 0); its collectives move nothing.
    A group that already has ``n`` ranks is kept."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks exists; the dry run wants {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# substrings of the functional collectives' op names -> the JAX names
_OP_NAMES = (("all_gather", "all-gather"), ("reduce_scatter",
                                            "reduce-scatter"),
             ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
             ("alltoall", "all-to-all"), ("permute", "collective-permute"))


def _collective_name(op_name: str) -> Optional[str]:
    for part, name in _OP_NAMES:
        if part in op_name:
            return name
    return None


def collective_stats(calls: Iterable) -> Dict[str, Any]:
    """Sum output bytes of every collective a trace issued.

    ``calls``: (op name, output bytes) of each ``c10d_functional`` /
    ``_dtensor`` op, as ``_StepCounter`` records them.  Every call counts,
    a layer loop's once per layer."""
    per_op: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    counts: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    for op_name, nbytes in calls:
        name = _collective_name(op_name)
        if name is None:
            continue
        per_op[name] += nbytes
        counts[name] += 1
    return {"bytes_by_op": per_op, "counts": counts,
            "total_bytes": sum(per_op.values())}


def _storage_bytes(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


class _StepCounter(TorchDispatchMode):
    """Counts what one rank does in a traced step: the FLOPs of its local
    ops, the live bytes of the local tensors they make (and their peak),
    and the collectives it issues.

    An op on DTensors goes to DTensor (``_dtensor_op``), which
    redistributes and runs the local op, which lands here; the fake
    tensors of DTensor's sharding propagation are not counted.  A local
    op that makes new tensors and repeats an earlier op's shapes,
    dtypes and arguments returns fresh meta tensors of the earlier
    outputs' shapes with its FLOPs, instead of running the meta kernel
    again (most of the trace's time at long sequences)."""

    _COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.made = set()  # ids of the live tensors counted
        self.collectives = []
        self._pass = False  # the next DTensor op goes to DTensor
        self._replays = {}
        self._ops = {}  # an op's outputs and FLOPs by its arguments

    def _track(self, t: torch.Tensor) -> None:
        nbytes = _storage_bytes(t)
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        self.made.add(id(t))
        weakref.finalize(t, self._free, id(t), nbytes)

    def _free(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        self.made.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._pass:
                self._pass = False
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or \
                torch._C._get_dispatch_mode(
                    torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)
        key = _op_key(func, args, kwargs)
        if key is not None and key in self._ops:
            metas, flops = self._ops[key]
            self.flops += flops
            out = _rebuild(metas)
            for t in _tensors(out):
                self._track(t)
            return out
        out = func(*args, **kwargs)
        flops = 0
        if func._overloadpacket in flop_registry:
            flops = flop_registry[func._overloadpacket](*args, **kwargs,
                                                        out_val=out)
        self.flops += flops
        inputs = {id(a) for a in _tensors(args) + _tensors(kwargs)}
        outs = _tensors(out)
        if func.namespace in self._COLL_NAMESPACES:
            self.collectives.append(
                (func.__name__, sum(_storage_bytes(t) for t in outs)))
        elif key is not None and all(t.device.type == "meta" for t in outs):
            self._ops[key] = (_metas(out), flops)
        # a view or an in-place op's outputs share an input's storage (the
        # schema says so: below autograd no tensor is marked a view)
        if all(r.alias_info is None for r in func._schema.returns):
            for t in outs:
                if id(t) not in inputs and id(t) not in self.made:
                    self._track(t)
        return out

    def replay(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` on local meta tensors, counted.  Without
        autograd, a call whose arguments repeat an earlier call's shapes,
        dtypes and values (the same function at every layer) replays that
        call's count — its FLOPs, its peak of live bytes above the live
        bytes at its start, its collectives — and returns fresh meta
        tensors of its outputs' shapes, instead of running it again."""
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in _tensors((args, kwargs)))
        key = None if grad else _call_key(fn, args, kwargs)
        if key is not None and key in self._replays:
            out, flops, rise, colls = self._replays[key]
            self.flops += flops
            self.peak = max(self.peak, self.live + rise)
            self.collectives.extend(colls)
            out = _rebuild(out)
            for t in _tensors(out):
                self._track(t)
            return out
        flops0, live0, peak0 = self.flops, self.live, self.peak
        n_colls = len(self.collectives)
        self.peak = self.live
        try:
            out = fn(*args, **kwargs)
        finally:
            rise = self.peak - live0
            self.peak = max(peak0, self.peak)
        if key is not None:
            self._replays[key] = (
                _metas(out),
                self.flops - flops0, rise, self.collectives[n_colls:])
        return out

    def _dtensor_op(self, func, args, kwargs):
        """``func`` on DTensors, this mode back on the stack for the local
        ops.  Where DTensor has no sharding for the op's inputs (a view
        that splits a sharded dim, an op with no strategy, a plan its
        redistribution cannot make), the inputs' shards on the last mesh
        dim, then on every mesh dim, are gathered first, as an SPMD
        partitioner falls back to replication."""
        mesh = _tensors((args, kwargs), DTensor)[0].device_mesh
        for keep in range(mesh.ndim, -1, -1):
            try:
                with self:
                    self._pass = True
                    return func(*_replicated(args, keep),
                                **_replicated(kwargs, keep))
            except (RuntimeError, NotImplementedError, IndexError) as e:
                if keep == 0 or not _no_sharding(e):
                    e.add_note(f"dry run: in {func} on DTensors")
                    raise
        raise AssertionError("unreachable")


def _no_sharding(e: Exception) -> bool:
    """Whether ``e`` is DTensor's: no strategy for the op, or none for its
    inputs' placements, or an index error of its redistribution planner
    (torch 2.11's raises one in zamba2's forward)."""
    if isinstance(e, IndexError):
        tb = e.__traceback__
        while tb.tb_next is not None:
            tb = tb.tb_next
        return "distributed/tensor" in tb.tb_frame.f_code.co_filename
    msg = str(e)
    return ("Sharding propagation failed" in msg
            or "does not have a sharding strategy" in msg)


def _replicated(tree, keep: int):
    """``tree`` with each DTensor's shards on mesh dims >= ``keep``
    gathered (``keep`` = the mesh's ndim: unchanged)."""
    if isinstance(tree, DTensor):
        pl = list(tree.placements)
        if all(not p.is_shard() and not p.is_partial() for p in pl[keep:]):
            return tree
        return tree.redistribute(
            tree.device_mesh, pl[:keep] + [Replicate()] * (len(pl) - keep))
    if isinstance(tree, dict):
        return {k: _replicated(v, keep) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replicated(v, keep) for v in tree)
    return tree


class _MetaOut:
    """A replayed output's shape, strides and dtype."""
    __slots__ = ("shape", "stride", "dtype")

    def __init__(self, t: torch.Tensor):
        self.shape, self.stride, self.dtype = tuple(t.shape), t.stride(), \
            t.dtype

    def empty(self) -> torch.Tensor:
        return torch.empty_strided(self.shape, self.stride, dtype=self.dtype,
                                   device="meta")


def _metas(tree):
    """``tree`` with each tensor as its ``_MetaOut``."""
    return map_with_path(lambda _, t: _MetaOut(t) if isinstance(
        t, torch.Tensor) else t, tree)


def _rebuild(tree):
    """``_metas``' inverse: a fresh meta tensor for each ``_MetaOut``."""
    return map_with_path(
        lambda _, m: m.empty() if isinstance(m, _MetaOut) else m, tree)


def _op_key(func, args, kwargs):
    """``_call_key`` of an op that makes new tensors (no view, no in-place
    write, no collective), on meta tensors; else None."""
    schema = func._schema
    if schema.is_mutable or any(r.alias_info is not None
                                for r in schema.returns):
        return None
    return _call_key(func, args, kwargs)


def _call_key(fn, args, kwargs):
    """A hashable key of a call by its arguments' shapes, strides, dtypes
    and devices and its other arguments' values; None where an argument
    is neither (the call is then run)."""
    def one(a):
        if isinstance(a, torch.Tensor):
            if isinstance(a, DTensor) or a.device.type != "meta":
                raise TypeError
            return ("T", tuple(a.shape), a.stride(), a.dtype)
        if isinstance(a, (list, tuple)):
            return tuple(one(x) for x in a)
        if isinstance(a, dict):
            return tuple((k, one(v)) for k, v in sorted(a.items()))
        hash(a)
        return a
    try:
        return (fn, one(args), one(kwargs))
    except TypeError:
        return None


def _tensors(tree, cls=torch.Tensor) -> list:
    """The ``cls`` instances in nested lists, tuples and dicts."""
    if isinstance(tree, cls):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x, cls)]
    return []


# ---------------------------------------------------------------------------
# sharding strategies of the model functions DTensor cannot shard op by op
# ---------------------------------------------------------------------------

def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for dim in reversed(tuple(shape)):
        stride.append(acc)
        acc *= dim
    return tuple(reversed(stride))


def _local(t, spec: P, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's shard of ``t`` laid out by ``spec`` (a plain tensor is
    every rank's whole)."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(mesh, spec_placements(spec, mesh)).to_local()


def _global(local: torch.Tensor, spec: P, mesh: DeviceMesh,
            shape) -> DTensor:
    return DTensor.from_local(local, mesh, spec_placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _attention_strategy(counter: "_StepCounter", fn):
    """``_attend_chunked`` (q (B,Sq,Hq,hd), k and v (B,Sk,Hk,hd)) on each
    rank's batch rows and heads: batch over the data axes and heads over
    ``model`` where they divide, each rank's kv heads by ``_kv_local``.
    The online-softmax blocks run locally."""
    def attend(q, k, v, q_pos, k_pos, *args, **kwargs):
        if not isinstance(q, DTensor):
            return counter.replay(fn, q, k, v, q_pos, k_pos, *args,
                                  **kwargs)
        mesh, hq = q.device_mesh, q.shape[2]
        spec = _fit(P(shard_batch_axes(mesh), None, "model"), q.shape, mesh)
        out = counter.replay(fn, _local(q, spec, mesh),
                             _kv_local(k, spec, mesh, hq),
                             _kv_local(v, spec, mesh, hq),
                             _local(q_pos, P(), mesh),
                             _local(k_pos, P(), mesh), *args, **kwargs)
        return _global(out, spec, mesh, q.shape)
    return attend


def _kv_local(k, q_spec: P, mesh: DeviceMesh, hq: int):
    """This rank's kv heads for its query heads: k (B,S,Hk,hd) with its
    heads over ``model`` where they divide, else, where the query heads
    are sharded, the kv heads repeated to Hq and this rank's slice."""
    spec = _fit(P(q_spec[0], None, "model"), k.shape, mesh)
    if q_spec[2] is None:
        return _local(k, P(q_spec[0]), mesh)
    if spec[2] is not None:
        return _local(k, spec, mesh)
    share = hq // _axis_size(mesh, "model")
    r = mesh.get_local_rank("model")
    return torch.repeat_interleave(
        _local(k, P(q_spec[0]), mesh), hq // k.shape[2],
        dim=2)[:, :, r * share:(r + 1) * share]


def _seq_sharded(t) -> bool:
    """Whether DTensor ``t`` (B,S,...) has its S dim over ``model`` (a
    context-parallel KV cache)."""
    names = t.device_mesh.mesh_dim_names
    return any(p_.is_shard(1) and n == "model"
               for p_, n in zip(t.placements, names))


def _scores_strategy(counter: "_StepCounter", fn):
    """``_gqa_scores`` (q (B,Sq,Hq,hd), k (B,Sk,Hk,hd) -> (B,Hq,Sq,Sk))
    per head, as ``_attention_strategy``; against a context-parallel
    cache (S over ``model``) per key block, every query head on each
    rank, the scores' Sk over ``model``."""
    def scores(q, k):
        if not isinstance(q, DTensor) and not isinstance(k, DTensor):
            return counter.replay(fn, q, k)
        mesh = (q if isinstance(q, DTensor) else k).device_mesh
        axes = shard_batch_axes(mesh)
        b, sq, hq, _ = q.shape
        out_shape = (b, hq, sq, k.shape[1])
        if isinstance(k, DTensor) and _seq_sharded(k):
            rows = _fit(P(axes), q.shape, mesh)[0]
            kspec = _fit(P(rows, "model"), k.shape, mesh)
            out = counter.replay(fn, _local(q, P(rows), mesh),
                                 _local(k, kspec, mesh))
            return _global(out, P(rows, None, None, "model"), mesh,
                           out_shape)
        q_spec = _fit(P(axes, None, "model"), q.shape, mesh)
        out = counter.replay(fn, _local(q, q_spec, mesh),
                             _kv_local(k, q_spec, mesh, hq))
        return _global(out, P(q_spec[0], q_spec[2]), mesh, out_shape)
    return scores


def _out_strategy(counter: "_StepCounter", fn):
    """``_gqa_out`` (p (B,Hq,Sq,Sk), v (B,Sk,Hk,hd) -> (B,Sq,Hq,hd)) per
    head; against a context-parallel cache each rank's key block gives a
    partial sum, reduced over ``model``."""
    def out_(p, v):
        if not isinstance(p, DTensor) and not isinstance(v, DTensor):
            return counter.replay(fn, p, v)
        mesh = (p if isinstance(p, DTensor) else v).device_mesh
        axes = shard_batch_axes(mesh)
        b, hq, sq, _ = p.shape
        out_shape = (b, sq, hq, v.shape[3])
        if isinstance(v, DTensor) and _seq_sharded(v):
            rows = _fit(P(axes), p.shape, mesh)[0]
            part = counter.replay(
                fn, _local(p, P(rows, None, None, "model"), mesh),
                _local(v, _fit(P(rows, "model"), v.shape, mesh), mesh))
            pl = [Partial() if n == "model" else pl_ for pl_, n in zip(
                spec_placements(P(rows), mesh), mesh.mesh_dim_names)]
            return DTensor.from_local(part, mesh, pl, run_check=False,
                                      shape=torch.Size(out_shape),
                                      stride=_contiguous_stride(out_shape))
        q_spec = _fit(P(axes, None, "model"), (b, sq, hq, v.shape[3]), mesh)
        out = counter.replay(fn, _local(p, P(q_spec[0], q_spec[2]), mesh),
                             _kv_local(v, q_spec, mesh, hq))
        return _global(out, q_spec, mesh, out_shape)
    return out_


def _rmsnorm_strategy(counter: "_StepCounter", fn):
    """``ops.rmsnorm`` row by row: x's batch rows over the data axes, its
    other dims and the scale whole on each rank."""
    def rmsnorm(x, scale, **kwargs):
        if not isinstance(x, DTensor):
            return counter.replay(fn, x, scale, **kwargs)
        mesh = x.device_mesh
        spec = _fit(P(shard_batch_axes(mesh)), x.shape, mesh)
        out = counter.replay(fn, _local(x, spec, mesh),
                             _local(scale, P(), mesh), **kwargs)
        return _global(out, spec, mesh, x.shape)
    return rmsnorm


def _reduce_over(local: torch.Tensor, spec: P, mesh: DeviceMesh,
                 over: tuple, op: str = "sum") -> torch.Tensor:
    """``local`` (laid out by ``spec`` on its other axes) all-reduced by
    ``op`` over the mesh axes ``over``."""
    pl = spec_placements(spec, mesh)
    shape = list(local.shape)
    for p_, n in zip(pl, mesh.mesh_dim_names):
        if p_.is_shard():
            shape[p_.dim] *= _axis_size(mesh, n)
    partial = [Partial(op) if n in over else p_
               for p_, n in zip(pl, mesh.mesh_dim_names)]
    d = DTensor.from_local(local, mesh, partial, run_check=False,
                           shape=torch.Size(shape),
                           stride=_contiguous_stride(shape))
    return d.redistribute(mesh, pl).to_local()


def _ce_strategy(counter: "_StepCounter", fn):
    """``_weighted_ce`` (logits (B,S,V), labels (B,S), weights (B,))
    vocab-parallel: each rank keeps its batch rows and vocab shard of the
    logits; the softmax's max and sum and the label's logit are reduced
    over ``model``, the weighted mean over the data axes."""
    def weighted_ce(logits, labels, weights=None):
        if not isinstance(logits, DTensor):
            return counter.replay(fn, logits, labels, weights)
        mesh = logits.device_mesh
        axes = shard_batch_axes(mesh)
        spec = _fit(P(axes, None, "model"), logits.shape, mesh)
        rows, vocab = P(spec[0], None), spec[2]
        ll = _local(logits, spec, mesh).float()
        lab = _local(labels, rows, mesh)
        valid = lab != IGNORE
        safe = torch.where(valid, lab, 0).long()
        over = (vocab,) if vocab else ()
        m = _reduce_over(torch.amax(ll, dim=-1).detach(), rows, mesh, over,
                         "max")
        sumexp = _reduce_over(torch.sum(torch.exp(ll - m[..., None]),
                                        dim=-1), rows, mesh, over)
        v_loc = ll.shape[-1]
        idx = safe - (mesh.get_local_rank(vocab) * v_loc if vocab else 0)
        mine = (idx >= 0) & (idx < v_loc)
        picked = torch.where(mine, torch.gather(
            ll, -1, torch.clamp(idx, 0, v_loc - 1)[..., None])[..., 0], 0.0)
        picked = _reduce_over(picked, rows, mesh, over)
        nll = (m + torch.log(sumexp) - picked) * valid
        per_example = (torch.sum(nll, dim=1)
                       / torch.clamp_min(torch.sum(valid, dim=1), 1))
        w = (torch.ones_like(per_example) if weights is None
             else _local(weights, P(spec[0]), mesh))
        batch_over = tuple(a for a in axes if spec[0] is not None)
        num = _reduce_over(torch.sum(per_example * w), P(), mesh,
                           batch_over)
        den = _reduce_over(torch.sum(w), P(), mesh, batch_over)
        total = num / torch.clamp_min(den, 1e-9)
        return (_global(total, P(), mesh, ()),
                _global(per_example, P(spec[0]), mesh, labels.shape[:1]))
    return weighted_ce


def _moe_strategy(counter: "_StepCounter", fn):
    """``moe_ffn`` expert-parallel: each rank routes and dispatches its
    own batch rows (the capacity taken from its own token count), runs
    its |E|/|model| experts on their rows of the (E, C, d) buffer, and
    gathers the experts' outputs over ``model`` to combine them.  The
    expert and router weights are gathered over ``data`` where ``fsdp``
    shards them; the shared expert is the tensor-parallel MLP on
    DTensors.  The load-balance loss is each rank's, averaged over the
    data axes."""
    def moe_ffn(params, cfg, x):
        if not isinstance(x, DTensor):
            return fn(params, cfg, x)
        mesh = x.device_mesh
        axes = shard_batch_axes(mesh)
        e, d = cfg.n_experts, x.shape[-1]
        xspec = _fit(P(axes), x.shape, mesh)
        xl = _local(x, xspec, mesh)
        xt = xl.reshape(-1, d)
        probs, expert, gate = moe._route(
            {"router": _local(params["router"], P(), mesh)}, xt)
        aux = moe._aux(probs, expert, e)
        cap = moe._capacity(xt.shape[0], e, cfg.moe_capacity_factor)
        order, slot, keep = moe.dispatch(expert, e, cap)
        buf = xt.new_zeros((e * cap + 1, d)).index_put((slot,), xt[order])
        hidden = buf[: e * cap].reshape(e, cap, d)
        wspec = _fit(P("model"), params["w_gate"].shape, mesh)
        if wspec[0] is not None:
            share = e // _axis_size(mesh, "model")
            r = mesh.get_local_rank("model")
            hidden = hidden[r * share:(r + 1) * share]
        wg, wu, wd = (_local(params[k], wspec, mesh)
                      for k in ("w_gate", "w_up", "w_down"))
        out = torch.bmm(F.silu(torch.bmm(hidden, wg))
                        * torch.bmm(hidden, wu), wd)
        if wspec[0] is not None:
            # each (data, model) rank's experts: gather over model
            n_data = _axis_size(mesh, axes)
            out = _local(_global(out[None], P(axes, "model"), mesh,
                                 (n_data, e) + tuple(out.shape[1:])),
                         P(axes), mesh)[0]
        flat = torch.cat([out.reshape(e * cap, d), out.new_zeros((1, d))])
        routed = (flat[slot] * keep[:, None])[torch.argsort(order)]
        routed = routed * gate[:, None].to(xt.dtype)
        y = _global(routed.reshape(xl.shape), xspec, mesh, x.shape)
        if cfg.use_shared_expert:
            y = y + mlp(subparams(params, "shared"), x, cfg.act)
        aux = DTensor.from_local(
            aux, mesh, [Partial("avg") if n in axes else Replicate()
                        for n in mesh.mesh_dim_names], run_check=False)
        return y, aux
    return moe_ffn


def _conv_strategy(counter: "_StepCounter", fn):
    """``causal_conv`` (x (B,S,C), w (K,C), b (C,)) per channel: batch
    over the data axes, channels over ``model`` where they divide."""
    def causal_conv(x, w, b):
        if not isinstance(x, DTensor):
            return counter.replay(fn, x, w, b)
        mesh = x.device_mesh
        spec = _fit(P(shard_batch_axes(mesh), None, "model"), x.shape, mesh)
        out = counter.replay(fn, _local(x, spec, mesh),
                             _local(w, P(None, spec[2]), mesh),
                             _local(b, P(spec[2]), mesh))
        return _global(out, spec, mesh, x.shape)
    return causal_conv


def _ssd_strategy(counter: "_StepCounter", fn):
    """``ssd_chunked`` (x (b,s,nh,hd), a (b,s,nh), B and C (b,s,n), h0
    (b,nh,hd,n)) per head: batch over the data axes, heads over ``model``
    where they divide, B and C whole on each rank."""
    def ssd_chunked(x, a, B, C, chunk, h0=None):
        if not isinstance(x, DTensor):
            return counter.replay(fn, x, a, B, C, chunk, h0)
        mesh = x.device_mesh
        axes = shard_batch_axes(mesh)
        spec = _fit(P(axes, None, "model"), x.shape, mesh)
        bspec = P(spec[0])
        hspec = P(spec[0], spec[2])
        y, h = counter.replay(
            fn, _local(x, spec, mesh), _local(a, spec, mesh),
            _local(B, bspec, mesh), _local(C, bspec, mesh), chunk,
            None if h0 is None else _local(h0, hspec, mesh))
        b, _, nh, hd = x.shape
        return (_global(y, spec, mesh, x.shape),
                _global(h, hspec, mesh, (b, nh, hd, B.shape[-1])))
    return ssd_chunked


def _xlstm_strategy(counter: "_StepCounter", fn):
    """An xLSTM block (``mlstm_block``, ``slstm_block``) data-parallel:
    each rank runs its batch rows (x and the state batch-first) with the
    block's weights gathered whole; its time loops run locally."""
    def block(params, cfg, x, state=None, **kwargs):
        if not isinstance(x, DTensor):
            return counter.replay(fn, params, cfg, x, state, **kwargs)
        mesh = x.device_mesh
        axes = shard_batch_axes(mesh)

        def batch_spec(t):
            return _fit(P(axes), t.shape, mesh)
        local_params = map_with_path(lambda _, t: _local(t, P(), mesh),
                                     params)
        local_state = None if state is None else map_with_path(
            lambda _, t: _local(t, batch_spec(t), mesh), state)
        out, new_state = counter.replay(fn, local_params, cfg,
                                        _local(x, batch_spec(x), mesh),
                                        local_state, **kwargs)
        b = x.shape[0]

        def to_global(_, t):
            shape = (b,) + tuple(t.shape[1:])
            return _global(t, _fit(P(axes), shape, mesh), mesh, shape)
        return (_global(out, batch_spec(x), mesh, x.shape),
                map_with_path(to_global, new_state))
    return block


@contextlib.contextmanager
def _strategies(counter: "_StepCounter"):
    """While active, the model functions below take their DTensors
    through the strategies above."""
    patched = [(model_module, "_weighted_ce", _ce_strategy),
               (attention, "_attend_chunked", _attention_strategy),
               (attention, "_gqa_scores", _scores_strategy),
               (attention, "_gqa_out", _out_strategy),
               (ops, "rmsnorm", _rmsnorm_strategy),
               (moe, "moe_ffn", _moe_strategy),
               (mamba2, "causal_conv", _conv_strategy),
               (mamba2, "ssd_chunked", _ssd_strategy),
               (xlstm, "mlstm_block", _xlstm_strategy),
               (xlstm, "slstm_block", _xlstm_strategy)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    try:
        for mod, name, strategy in patched:
            setattr(mod, name, strategy(counter, getattr(mod, name)))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def build_step(model: Model, shape: ShapeConfig, optimizer: str = "sgd"):
    """Returns (step_fn, optimizer or None) for the shape kind.  Each step
    runs ``impl="chunked"`` attention, as the JAX package lowers its
    default ``Model.forward``."""
    if shape.kind == "train":
        opt = adam(1e-4) if optimizer == "adam" else sgd(1e-2)

        def train_step(params, opt_state, batch):
            loss, _ = model.loss(params, batch, impl="chunked")
            leaves = list(params)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, [params[k] for k in leaves], allow_unused=True,
                materialize_grads=True)))
            updates, opt_state = opt.update(grads, opt_state, params)
            params = tree_add(params, updates)
            return params, opt_state, loss

        return train_step, opt
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            logits, aux, hidden = model.forward(params, batch,
                                                impl="chunked")
            # serving prefill returns last-position logits
            return logits[:, -1, :]

        return prefill_step, None

    def serve_step(params, state, batch):
        # the traced position of the JAX package is a Python int here
        return model.decode_step(params, state, batch["token"],
                                 shape.seq_len - 1)

    return serve_step, None


def abstract_params(model: Model, dtype=DTYPE):
    """{key: meta tensor} of ``model.init``'s shapes, floats in ``dtype``:
    the init runs under ``FakeTensorMode``, which allocates nothing."""
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return {k: torch.empty(v.shape, device="meta",
                           dtype=dtype if v.is_floating_point() else v.dtype)
            for k, v in params.items()}


def _abstract(fn, params_abs):
    """``fn(params_abs)`` on the meta device, every tensor of its nested
    result a fresh meta tensor of the same shape and dtype."""
    with torch.no_grad():
        out = fn(params_abs)
    return map_with_path(
        lambda _, t: torch.empty(t.shape, dtype=t.dtype, device="meta"), out)


def _shard(abs_tree, spec_tree, mesh: DeviceMesh, requires_grad=False):
    """Each meta tensor of ``abs_tree`` as a DTensor on ``mesh``: this
    rank's meta shard, laid out by its spec."""
    def one(key, t):
        spec = _at(spec_tree, key)
        local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device="meta")
        d = DTensor.from_local(local, mesh, spec_placements(spec, mesh),
                               run_check=False, shape=t.shape,
                               stride=t.stride())
        return d.requires_grad_() if requires_grad else d
    return map_with_path(one, abs_tree)


def _at(tree, key: str):
    """The node at ``key`` (``map_with_path``'s keys) of nested dicts,
    lists and named tuples."""
    node = tree
    for part in key.split("/") if key else ():
        if part.startswith("#"):
            node = node[int(part[1:])]
        elif part.startswith("."):
            node = getattr(node, part[1:])
        else:
            node = node[part]
    return node


def _place(tree, spec_tree, mesh: DeviceMesh):
    """Each DTensor of ``tree`` redistributed to its spec (what jit's
    ``out_shardings`` asks of XLA)."""
    def one(key, t):
        if not isinstance(t, DTensor):
            return t
        spec = spec_tree if isinstance(spec_tree, P) else _at(spec_tree, key)
        return t.redistribute(mesh, spec_placements(spec, mesh))
    return map_with_path(one, tree)


def _plain_leaves(tree) -> list:
    """One rank's tensors in ``tree``: each DTensor's local shard, each
    plain tensor whole."""
    leaves = []

    def one(_, t):
        if isinstance(t, torch.Tensor):
            leaves.append(t._local_tensor if isinstance(t, DTensor) else t)
    map_with_path(one, tree)
    return leaves


def _local_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _plain_leaves(tree))


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _mesh(multi_pod: bool, mesh_split: Optional[tuple]) -> DeviceMesh:
    if mesh_split is None:
        return make_production_mesh(multi_pod=multi_pod)
    # perf-iteration rebalance: same 256 ranks, another (data, model)
    assert mesh_split[0] * mesh_split[1] == 256
    return DeviceMesh("cpu", torch.arange(256).reshape(mesh_split),
                      mesh_dim_names=("data", "model"))


def dry_run(arch_id: str, shape_name: str, multi_pod: bool = False,
            sharding_mode: str = "tp", optimizer: str = "sgd",
            context_parallel: bool = False, remat: bool = False,
            mesh_split: Optional[tuple] = None,
            verbose: bool = True) -> Dict[str, Any]:
    """One combination's record; needs a process group of 256 (single)
    or 512 (multi) ranks, as ``force_world`` starts."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch_id, shape=shape)
    if remat:
        cfg = cfg.with_(remat=True)
    model = Model(cfg)
    mesh = _mesh(multi_pod, mesh_split)
    record: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "sharding": sharding_mode,
        "context_parallel": context_parallel,
        "remat": remat,
        "optimizer": optimizer if shape.kind == "train" else None,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    t0 = time.perf_counter()

    params_abs = abstract_params(model)
    p_specs = param_specs(cfg, params_abs, mesh, mode=sharding_mode)
    in_specs = model.input_specs(shape, dtype=DTYPE)
    b_specs = batch_specs(in_specs, mesh)
    step, opt = build_step(model, shape, optimizer)

    params = _shard(params_abs, p_specs, mesh,
                    requires_grad=shape.kind == "train")
    batch = _shard(in_specs, b_specs, mesh)
    counter = _StepCounter()
    with implicit_replication(), _strategies(counter):
        if shape.kind == "train":
            opt_state = _opt_state(opt, params_abs, p_specs, mesh)
            args = (params, opt_state, batch)
            with counter:
                new_params, new_opt, loss = step(*args)
                out = (_place(new_params, p_specs, mesh),
                       _place(new_opt, _opt_specs(new_opt, p_specs), mesh),
                       _place(loss, P(), mesh))
        elif shape.kind == "prefill":
            args = (params, batch)
            out_spec = _fit(
                P(tuple(n for n in ("pod", "data")
                        if n in mesh.mesh_dim_names), "model"),
                (shape.global_batch, cfg.vocab_size), mesh)
            with counter:
                out = _place(step(*args), out_spec, mesh)
        else:  # decode
            state_abs = _abstract(
                lambda p: model.init_decode_state(
                    p, shape.global_batch, shape.seq_len, dtype=DTYPE),
                params_abs)
            s_specs = decode_state_specs(cfg, state_abs, mesh,
                                         context_parallel=context_parallel)
            state = _shard(state_abs, s_specs, mesh)
            args = (params, state, batch)
            with counter:
                logits, new_state = step(*args)
                out = (_place(logits, P(), mesh),
                       _place(new_state, s_specs, mesh))
    record["trace_s"] = round(time.perf_counter() - t0, 2)

    arg_ids = {id(t) for t in _plain_leaves(args)}
    alias = _local_bytes([t for t in _plain_leaves(out) if id(t) in arg_ids])
    out_bytes = _local_bytes(out)
    record["memory"] = {
        "argument_size_in_bytes": _local_bytes(args),
        "output_size_in_bytes": out_bytes,
        # the outputs the step made are inside its peak of live bytes
        "temp_size_in_bytes": counter.peak - (out_bytes - alias),
        "alias_size_in_bytes": alias,
    }
    record["memory"]["bytes_per_device"] = _memory_total(record["memory"])
    record["cost"] = {"flops": counter.flops}
    record["collectives"] = collective_stats(counter.collectives)
    record["ok"] = True
    if verbose:
        print(f"[dryrun] {arch_id} x {shape_name} x "
              f"{record['mesh']} ({sharding_mode}) OK — "
              f"trace {record['trace_s']}s "
              f"mem/device "
              f"{record['memory']['bytes_per_device'] / 2**30:.2f} GiB "
              f"flops {record['cost']['flops']:.3e} "
              f"coll {record['collectives']['total_bytes'] / 2**30:.2f} GiB",
              flush=True)
    return record


def _opt_state(opt, params_abs, p_specs, mesh: DeviceMesh):
    """The optimiser's state for ``params_abs``: its moment trees sharded
    as the params, its step counter a plain scalar, as ``opt.init`` makes
    it."""
    state = opt.init({k: torch.empty(0) for k in params_abs})
    for k in state:
        if k in ("m", "v", "mu"):
            state[k] = _shard(params_abs, p_specs, mesh)
    return state


def _opt_specs(opt_abs, p_specs):
    """Optimizer-state sharding: momentum-like trees mirror the params."""
    out = {}
    for k, v in opt_abs.items():
        if k in ("m", "v", "mu"):
            out[k] = p_specs
        else:
            out[k] = map_with_path(lambda _, t: P(), v)
    return out


def _memory_total(mem: Dict[str, int]) -> int:
    return (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
            + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) pair")
    ap.add_argument("--sharding", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--context-parallel", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--mesh-split", default=None,
                    help="perf iteration: 'DATA,MODEL' split of 256 ranks "
                         "(e.g. 32,8)")
    ap.add_argument("--out", default=None, help="JSONL output path")
    args = ap.parse_args(argv)
    mesh_split = (tuple(int(x) for x in args.mesh_split.split(","))
                  if args.mesh_split else None)

    pairs = []
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for a in archs:
        for s in shapes:
            for m in meshes:
                pairs.append((a, s, m))

    records = []
    failures = 0
    for arch, shp, mesh_kind in pairs:
        try:
            rec = dry_run(arch, shp, multi_pod=(mesh_kind == "multi"),
                          sharding_mode=args.sharding,
                          optimizer=args.optimizer,
                          context_parallel=args.context_parallel,
                          remat=args.remat, mesh_split=mesh_split)
        except Exception as e:  # a failure here is a bug in the system
            failures += 1
            rec = {"arch": arch, "shape": shp, "mesh": mesh_kind,
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[dryrun] {arch} x {shp} x {mesh_kind} FAILED: {e}",
                  flush=True)
        records.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    ok = sum(1 for r in records if r.get("ok"))
    print(f"[dryrun] {ok}/{len(records)} combinations traced", flush=True)
    return 1 if failures else 0


# The production mesh wants 512 ranks.  The fake world is process-global,
# so it only starts when this module IS the program (``python -m
# repro_torch.launch.dryrun``) or on explicit opt-in via
# REPRO_DRYRUN_FORCE_DEVICES=N: importing the module as a library starts
# no process group.
if __name__ == "__main__" or os.environ.get("REPRO_DRYRUN_FORCE_DEVICES"):
    force_world(int(os.environ.get("REPRO_DRYRUN_FORCE_DEVICES", "512")))

if __name__ == "__main__":
    sys.exit(main())
