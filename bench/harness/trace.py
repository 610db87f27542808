"""One round under ``torch.profiler``, read from the profiler's raw
events (building its Python event tree for a round of some hundred
thousand launches takes minutes).

What it gives the metric readers (``Profiled``): the round's wall and
the card's busy time (the union of kernel, copy and fill intervals), the
device operations by name, and for each named host range (the program's
spans, entered as ``torch.profiler.record_function`` ranges by
``Recorder(annotate=True)``) the device time and launches of the
operations launched inside each instance of it.

Each device operation is given one host time: the start of the host
call that launched it (the CUDA runtime or driver event of the same
correlation id; the backward's launches from autograd's device thread
count by that time too, as the host thread waits inside the range).  An
operation whose launch the profiler missed (a library's own CUDA
runtime) was launched after the launch of the linked operation before it
in device order and before that of the one after it, and before it
started: it counts only where all of that lies inside one instance.  So
an operation belongs to at most one instance of a range, and to at most
one of any set of ranges that do not nest; the device time of a set of
ranges is the union of their operations' intervals, never more than the
busy time.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
ROUND_RANGE = "bench.round"


@dataclasses.dataclass
class RangeStats:
    """Device work launched inside one instance of a host range."""
    start_ns: int
    end_ns: int
    device_s: float = 0.0
    ops: List[int] = dataclasses.field(default_factory=list)
    by_kernel: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)          # name -> [launches, seconds]


@dataclasses.dataclass
class Profiled:
    wall_s: float                      # host wall of the profiled round
    busy_s: float                      # union of device operations
    launches: int                      # kernels run on the card
    ops_by_name: Dict[str, List[float]]    # name -> [count, seconds]
    ranges: Dict[str, List[RangeStats]]    # host range name -> instances
    idle_by_host: Dict[str, float]     # what the host did -> idle s
    kinds: Dict[str, int]              # activity kinds seen (diagnostics)
    unlinked: Dict[str, int] = dataclasses.field(default_factory=dict)
    intervals: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)          # each device operation's (start, end)

    def range_device_s(self, *names: str) -> float:
        """Device time of the operations launched inside any instance of
        the named ranges: the union of their intervals."""
        held = {i for n in names for r in self.ranges.get(n, [])
                for i in r.ops}
        s = _seconds(_union([self.intervals[i] for i in held]))
        assert s <= self.busy_s * (1 + 1e-9), (names, s, self.busy_s)
        return s

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        ops = sorted(self.ops_by_name.items(), key=lambda kv: -kv[1][1])
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, v[1]] for n, v in ops[:top]],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its argument list, ``void`` and
    ``(anonymous namespace)::``."""
    name = name.replace("(anonymous namespace)::", "")
    base = name.split("(")[0] if "(" in name else name
    if base.startswith("void "):
        base = base[5:]
    return base[:limit]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _seconds(union: List[Tuple[int, int]]) -> float:
    return sum(b - a for a, b in union) * 1e-9


def _host_times(dev, launch_at) -> List[Tuple[float, float]]:
    """For each device operation, the earliest and latest host time at
    which it can have been launched: its launch's start where the
    profiler linked it; otherwise from the launch of the linked operation
    before it in device order (-inf where there is none) to the earlier
    of the next one's launch and its own start."""
    order = sorted(range(len(dev)), key=lambda i: dev[i][0])
    out: List[Tuple[float, float]] = [(0.0, 0.0)] * len(dev)
    prev, waiting = float("-inf"), []
    for i in order:
        t = launch_at.get(dev[i][3])
        if t is None:
            waiting.append(i)
            continue
        for u in waiting:
            out[u] = (prev, min(t, dev[u][0]))
        waiting = []
        out[i] = (t, t)
        prev = t
    for u in waiting:
        out[u] = (prev, dev[u][0])
    return out


def _innermost(events: List[Tuple[int, int, str]],
               points: List[int]) -> List[Optional[str]]:
    """For each sorted point, the name of the innermost of the properly
    nested ``events`` (start, end, name) that holds it, or None."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] < events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _kind(e, on_device: bool, annotations) -> str:
    """The event's kineto activity kind; torch builds without
    ``activity_type`` are classified by name: on the device a range's
    projection carries the range's name and copies and fills name
    themselves, on the host the CUDA runtime and driver calls begin with
    ``cu``."""
    get = getattr(e, "activity_type", None)
    if get is not None:
        return get()
    name = e.name()
    if on_device:
        if name in annotations:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name in annotations:
        return "user_annotation"
    if name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def _attribute(ivs: List[Tuple[int, int]], dev, host_at
               ) -> List[RangeStats]:
    """The device work of each instance of one host range: the
    operations whose host times (``_host_times``) lie inside it."""
    ivs = sorted(ivs)
    stats = [RangeStats(a, b) for a, b in ivs]
    starts = [a for a, _ in ivs]
    for i, ((a, b, kname, _, _), (lo, hi)) in enumerate(zip(dev, host_at)):
        j = bisect.bisect_right(starts, lo) - 1
        if j < 0 or hi > ivs[j][1]:
            continue
        stats[j].ops.append(i)
        rec = stats[j].by_kernel.setdefault(short_name(kname), [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) * 1e-9
    for st in stats:     # busy time: operations may overlap
        st.device_s = _seconds(_union([dev[i][:2] for i in st.ops]))
    return stats


def read_events(events: Iterable, range_names: Iterable[str],
                wall_s: float) -> Profiled:
    range_names = set(range_names)
    known = range_names | {ROUND_RANGE}
    dev, launch_at = [], {}
    host_ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    main_tid, round_iv = None, None
    annotations, cpu_ops = [], []
    kinds: Dict[str, int] = defaultdict(int)
    for e in events:
        on_device = str(e.device_type()).endswith("CUDA")
        kind = _kind(e, on_device, known)
        kinds[("device:" if on_device else "host:") + kind] += 1
        if on_device:
            if kind in DEVICE_OPS:
                a = e.start_ns()
                dev.append((a, a + e.duration_ns(), e.name(),
                            e.correlation_id(), kind))
            continue
        if kind in LAUNCH_KINDS:
            launch_at[e.correlation_id()] = e.start_ns()
            continue
        a = e.start_ns()
        iv = (a, a + e.duration_ns(), e.name(), e.start_thread_id())
        if kind == "user_annotation":
            if iv[2] == ROUND_RANGE:
                main_tid, round_iv = iv[3], iv[:2]
            elif iv[2] in range_names:
                host_ranges[iv[2]].append(iv[:2])
            annotations.append(iv)
        elif kind == "cpu_op":
            cpu_ops.append(iv)

    ops_by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    launches = 0
    for a, b, name, _, kind in dev:
        rec = ops_by_name[short_name(name)]
        rec[0] += 1
        rec[1] += (b - a) * 1e-9
        launches += kind == "kernel"

    host_at = _host_times(dev, launch_at)
    ranges = {name: _attribute(ivs, dev, host_at)
              for name, ivs in host_ranges.items()}
    unlinked: Dict[str, int] = defaultdict(int)
    for a, b, kname, corr, kind in dev:
        if corr not in launch_at:
            unlinked[short_name(kname)] += 1

    busy_iv = _union([(a, b) for a, b, *_ in dev])
    busy = _seconds(busy_iv)
    idle: Dict[str, float] = defaultdict(float)
    if round_iv is not None and busy_iv:
        edges = ([(round_iv[0], busy_iv[0][0])]
                 + [(busy_iv[i][1], busy_iv[i + 1][0])
                    for i in range(len(busy_iv) - 1)]
                 + [(busy_iv[-1][1], round_iv[1])])
        gaps = [(a, b) for a, b in edges if b > a]
        mids = [(a + b) // 2 for a, b in gaps]
        main = [iv[:3] for iv in annotations
                if iv[3] == main_tid and iv[2] != ROUND_RANGE]
        ops = [iv[:3] for iv in cpu_ops if iv[3] == main_tid]
        span_at = _innermost(main, mids)
        op_at = _innermost(ops, mids)
        for (a, b), sp, op in zip(gaps, span_at, op_at):
            label = f"{sp or '-'} > {op or 'python'}"
            idle[label] += (b - a) * 1e-9
    return Profiled(wall_s=wall_s, busy_s=busy, launches=launches,
                    ops_by_name=dict(ops_by_name), ranges=ranges,
                    idle_by_host=dict(idle), kinds=dict(kinds),
                    unlinked=dict(unlinked),
                    intervals=[(a, b) for a, b, *_ in dev])


def profile_round(fn: Callable[[], None], range_names: Iterable[str],
                  torch, on_card: bool = True) -> Profiled:
    """Run ``fn`` (one whole round) under the profiler, host and device
    activity both, inside a ``bench.round`` range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        if on_card:
            torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        with record_function(ROUND_RANGE):
            fn()
            sync()
        wall = time.perf_counter() - t0
    return read_events(prof.profiler.kineto_results.events(), range_names,
                       wall)
