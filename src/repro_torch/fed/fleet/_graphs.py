"""CUDA graphs of the fleet engine's vmapped steps, one for each shape.

One vmapped SGD step of a small cohort group is a few hundred small
kernels.  Issued one Python call at a time, the host's dispatch of them
takes longer than the card's work, so the host paces the group.  The
JAX package compiles a group into one program; the port's counterpart
is ``StepGraphs``.  It captures a step as a ``torch.cuda.CUDAGraph``
the first time it sees the step's shape key, and every later step with
that key is one replay.

A captured step reads and writes tensors at fixed addresses, allocated
outside the graphs' memory pool: the params stack (each replay writes
the new params back in place), the step's inputs, and the loss.  The
graphs' temporaries share one pool for each ``StepGraphs``.  Only a
replay uses them, and nothing reads them once it ends, so one graph may
reuse another's temporaries.  The step's kernels, their order and their
precision are the eager step's.

``ops.LAUNCHES`` counts launches of the hand-written kernels.  A capture
launches nothing, so its count is taken back, and each replay adds it.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.obs import get_recorder

Params = Dict[str, torch.Tensor]

# a capture costs about two eager steps of host time (an eager warm-up
# and the capture's own pass): a group of two steps or more pays for it
# at once, a group of one step runs eagerly unless its key is captured
MIN_CAPTURE_STEPS = 2
# captured steps kept, least recently used evicted first
CACHE_SIZE = 32


def _signature(tree) -> Tuple:
    """What a captured step's shapes depend on: each tensor's shape and
    dtype, with dict keys, in order."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    return tuple(_signature(v) for v in tree)


def _static(tree):
    """A contiguous buffer of each tensor's shape and dtype."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=tree.device)
    if isinstance(tree, dict):
        return {k: _static(v) for k, v in tree.items()}
    return tuple(_static(v) for v in tree)


def _load(static, tree) -> None:
    """Copy ``tree`` into its static buffers."""
    if isinstance(static, torch.Tensor):
        static.copy_(tree)
    elif isinstance(static, dict):
        for k, v in static.items():
            _load(v, tree[k])
    else:
        for s, v in zip(static, tree):
            _load(s, v)


@dataclasses.dataclass
class _Captured:
    """One captured step: ``p, loss = step(p, *fixed, *varying)`` with
    every tensor at a fixed address."""
    graph: Any                    # torch.cuda.CUDAGraph
    p: Params
    fixed: Tuple
    varying: Tuple
    loss: torch.Tensor
    launches: Dict[str, int]      # hand-written kernel launches a replay

    def replay(self, varying: Tuple) -> None:
        _load(self.varying, varying)
        self.graph.replay()
        for name, n in self.launches.items():
            ops.LAUNCHES[name] += n


class StepGraphs:
    """An engine's captured steps, keyed by the step function and its
    shapes, least recently used evicted first past ``CACHE_SIZE``.

    ``run`` runs ``n`` steps ``p, loss = step(p, *fixed, *varying(t))``
    from the params ``p``: as replays where the key is captured, or
    where it is new and ``n`` pays for a capture; else eagerly.  Tensors
    off the card always run eagerly, as does a new key while the
    profiler runs, so no capture happens under it."""

    def __init__(self, device: torch.device):
        self.device = device
        self._cache: "collections.OrderedDict[Tuple, _Captured]" = \
            collections.OrderedDict()
        self._pool = None
        self._side = None

    def run(self, step: Callable, p: Params, fixed: Tuple,
            varying: Callable[[int], Tuple], n: int
            ) -> Tuple[Params, torch.Tensor, bool]:
        """Returns (params, loss of the last step, whether replayed)."""
        metrics = get_recorder().metrics
        g = self._lookup(step, p, fixed, varying(0), n)
        if g is None:
            loss = None
            for t in range(n):
                p, loss = step(p, *fixed, *varying(t))
            metrics.counter("fleet.eager_steps").inc(n)
            return p, loss, False
        _load(g.p, p)
        _load(g.fixed, fixed)
        for t in range(n):
            g.replay(varying(t))
        metrics.counter("fleet.graph_replays").inc(n)
        return ({k: v.clone() for k, v in g.p.items()}, g.loss.clone(),
                True)

    def _lookup(self, step, p, fixed, varying, n) -> Optional[_Captured]:
        if self.device.type != "cuda":
            return None
        key = (step, _signature(p), _signature(fixed), _signature(varying))
        g = self._cache.get(key)
        if g is not None:
            self._cache.move_to_end(key)
            return g
        if n < MIN_CAPTURE_STEPS or torch._C._autograd._profiler_enabled():
            return None
        g = self._cache[key] = self._capture(step, p, fixed, varying)
        metrics = get_recorder().metrics
        metrics.counter("fleet.graph_captures").inc()
        if len(self._cache) > CACHE_SIZE:
            self._cache.popitem(last=False)
            metrics.counter("fleet.graph_evictions").inc()
        return g

    def _capture(self, step, p, fixed, varying) -> _Captured:
        """Warm the step up eagerly on a side stream (its result dropped),
        then capture it, writing the new params and the loss into the
        static buffers."""
        sp, sf, sv = _static(p), _static(fixed), _static(varying)
        _load(sp, p)
        _load(sf, fixed)
        _load(sv, varying)
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            _, loss = step(sp, *sf, *sv)
        cur.wait_stream(self._side)
        sloss = torch.empty_like(loss)
        graph = torch.cuda.CUDAGraph()
        before = dict(ops.LAUNCHES)
        # the cyclic collector may free another engine's graphs at any
        # allocation, and destroying a graph invalidates a capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                new_p, loss = step(sp, *sf, *sv)
                for k, v in sp.items():
                    v.copy_(new_p[k])
                sloss.copy_(loss)
        finally:
            if collecting:
                gc.enable()
        launches = {}
        for name, n in ops.LAUNCHES.items():
            if n != before.get(name, 0):
                launches[name] = n - before.get(name, 0)
                ops.LAUNCHES[name] = before.get(name, 0)
        return _Captured(graph, sp, sf, sv, sloss, launches)
