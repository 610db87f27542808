"""The Recorder: structured events + monotonic-clock spans + metrics.

Design constraints, in order:

1. **Determinism.**  Recording must never change what a runtime computes:
   the recorder reads ``time.perf_counter()``, records stream markers
   and writes to sinks — it never touches RNG streams, never reorders
   events, never forces lazy arrays; its one wait (below) is at the end
   of an outermost span.  ``tests/test_torch_obs.py`` holds bit-identical
   results with recording on vs off.
2. **Zero cost when off.**  ``get_recorder()`` returns ``NULL_RECORDER``
   unless a recorder was installed; its spans are one shared no-op
   context manager (no clock reads, no CUDA call) and its metrics are
   shared no-op instruments, so runtimes instrument unconditionally.
3. **Ambient, not threaded through.**  Runtimes call ``get_recorder()``
   instead of growing a ``recorder=`` parameter on every signature; the
   owner installs one with ``use_recorder(rec)`` / ``set_recorder``.

Spans nest via an explicit stack shared across ``scoped()`` views: each
emitted span record carries ``sid`` / ``parent`` / ``depth``, and both a
context-manager form (``with rec.span("eval"): ...``) and a manual form
(``span_begin`` / ``span_end``) exist — the async runtime needs manual
spans because its "round" is a record-window, not a lexical block.  With
``annotate=True`` every span also enters a ``torch.profiler`` range
(``_profiler_range``) so profiler traces line up with our phase names.

Stream time.  While CUDA is initialised, a recorder with sinks records a
timing event on the current stream at each span's begin and end; the
span's record carries their elapsed time as ``dev_s`` (seconds from the
stream finishing the work enqueued before the span to it finishing the
span's own work, the stream's waits for the host inside it included;
``None`` without CUDA).  Reading an event waits for it, and no wait may
land inside an open span, so the records emitted under an outermost
timed span are held until it ends: the recorder then waits on the end
events, fills ``dev_s`` and emits the held records in their order.
``flush_metrics`` / ``close`` emit whatever is still held.  The
``events`` argument is the seam: a zero-argument callable returning a
recorded marker (``synchronize()``, ``elapsed_time(other)`` in ms) or
None.
"""
from __future__ import annotations

import contextvars
import sys
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence

from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry

SCHEMA_VERSION = 1


class Span:
    """An open span; becomes one ``kind="span"`` record when ended.

    ``attrs`` stays mutable until the span ends, so call sites can stamp
    facts learned during the span (e.g. ``compile=True`` once the
    program cache is seen to have grown).
    """
    __slots__ = ("name", "sid", "parent", "depth", "t0", "attrs", "_ann",
                 "_ev0")

    def __init__(self, name: str, sid: int, parent: Optional[int],
                 depth: int, t0: float, attrs: Dict[str, Any]) -> None:
        self.name = name
        self.sid = sid
        self.parent = parent
        self.depth = depth
        self.t0 = t0
        self.attrs = attrs
        self._ann = None
        self._ev0 = None


class _NullSpan:
    """Shared recording-off span: a no-op context manager."""
    __slots__ = ()

    @property
    def attrs(self) -> Dict[str, Any]:
        return {}  # fresh throwaway dict: writes are accepted and dropped

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def cuda_event():
    """A timing CUDA event recorded on the current stream, or None where
    CUDA is not initialised (the default ``events`` of a Recorder)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _profiler_range(name: str):
    """A ``torch.profiler`` range over a span on the host's timeline.

    A user-scope range (``record_function``) is also drawn on the
    device's timeline under the span's name.  Where the profiler's events
    carry no activity type, a reader of the trace can tell that row from
    a kernel only by its name, so there the range takes the function
    scope, which stays on the host."""
    import torch
    if hasattr(torch._C._autograd._KinetoEvent, "activity_type"):
        return torch.profiler.record_function(name)
    return torch._C._profiler._RecordFunctionFast(name)


class _RunState:
    """Clock origin, sequence counter, span stack, metrics, the stream
    marker factory and the held records — shared by a Recorder and every
    ``scoped()`` view of it."""
    __slots__ = ("clock", "t0", "seq", "stack", "metrics", "events", "held")

    def __init__(self, clock, events) -> None:
        self.clock = clock
        self.t0 = clock()
        self.seq = 0
        self.stack = []  # open Spans, innermost last
        self.metrics = MetricsRegistry()
        self.events = events
        # (sinks, record, (begin, end) marks or None) emitted since a
        # timed span ended inside a still-open one; None when none is
        self.held = None


class Recorder:
    """Emits run/span/event/metrics records to its sinks."""
    enabled = True

    def __init__(self, sinks: Sequence = (), annotate: bool = False,
                 clock=time.perf_counter, events=None,
                 _state: Optional[_RunState] = None):
        self._sinks = tuple(sinks)
        self._annotate = bool(annotate)
        self._state = (_state if _state is not None else
                       _RunState(clock, events or cuda_event))

    @property
    def metrics(self) -> MetricsRegistry:
        return self._state.metrics

    def scoped(self, *sinks) -> "Recorder":
        """A view sharing this recorder's clock/spans/metrics but also
        emitting to ``sinks`` (how ``verbose=True`` adds a console)."""
        if not sinks:
            return self
        return Recorder(self._sinks + tuple(sinks), annotate=self._annotate,
                        _state=self._state)

    # -- emission ----------------------------------------------------------
    def _now(self) -> float:
        s = self._state
        return s.clock() - s.t0

    def _next_seq(self) -> int:
        s = self._state
        s.seq += 1
        return s.seq

    def _emit(self, record: dict, marks=None) -> None:
        st = self._state
        if marks is not None and st.held is None:
            st.held = []
        if st.held is None:
            for sink in self._sinks:
                sink.emit(record)
        else:
            st.held.append((self._sinks, record, marks))

    def _release(self) -> None:
        """Wait on the held spans' end markers, fill their ``dev_s`` and
        emit every held record in order."""
        st = self._state
        held, st.held = st.held, None
        for sinks, record, marks in held or ():
            if marks is not None:
                marks[1].synchronize()
                record["dev_s"] = marks[0].elapsed_time(marks[1]) * 1e-3
            for sink in sinks:
                sink.emit(record)

    def run_meta(self, **data) -> None:
        """One ``kind="run"`` record describing the run (runtime, engine,
        fleet size, seed, ...); every runtime emits this first."""
        self._emit({"v": SCHEMA_VERSION, "kind": "run",
                    "seq": self._next_seq(), "t": self._now(), "data": data})

    def event(self, name: str, **data) -> None:
        self._emit({"v": SCHEMA_VERSION, "kind": "event",
                    "seq": self._next_seq(), "t": self._now(),
                    "name": name, "data": data})

    # -- spans -------------------------------------------------------------
    def span_begin(self, name: str, **attrs) -> Span:
        st = self._state
        parent = st.stack[-1] if st.stack else None
        sp = Span(name, sid=self._next_seq(),
                  parent=parent.sid if parent is not None else None,
                  depth=len(st.stack), t0=self._now(), attrs=attrs)
        if self._annotate:
            sp._ann = _profiler_range(name)
            sp._ann.__enter__()
        if self._sinks:     # a recorder that emits nowhere never waits
            sp._ev0 = st.events()
        st.stack.append(sp)
        return sp

    def span_end(self, sp: Span) -> None:
        t1 = self._now()
        st = self._state
        marks = (sp._ev0, st.events()) if sp._ev0 is not None else None
        if sp._ann is not None:
            sp._ann.__exit__(None, None, None)
            sp._ann = None
        # tolerate a mis-nested end by unwinding to the span being closed
        while st.stack and st.stack[-1] is not sp:
            st.stack.pop()
        if st.stack:
            st.stack.pop()
        self._emit({"v": SCHEMA_VERSION, "kind": "span",
                    "seq": self._next_seq(), "t": sp.t0, "name": sp.name,
                    "t0": sp.t0, "t1": t1, "dur": t1 - sp.t0,
                    "sid": sp.sid, "parent": sp.parent, "depth": sp.depth,
                    "dev_s": None, "attrs": dict(sp.attrs)}, marks)
        if not st.stack and st.held is not None:
            self._release()

    @contextmanager
    def span(self, name: str, **attrs):
        sp = self.span_begin(name, **attrs)
        try:
            yield sp
        finally:
            self.span_end(sp)

    # -- lifecycle ---------------------------------------------------------
    def flush_metrics(self) -> None:
        """Emit the current metrics snapshot as a ``kind="metrics"``
        record (also done by ``close``), after any held records."""
        self._release()
        self._emit({"v": SCHEMA_VERSION, "kind": "metrics",
                    "seq": self._next_seq(), "t": self._now(),
                    "data": self._state.metrics.snapshot()})

    def close(self) -> None:
        self.flush_metrics()
        for sink in self._sinks:
            sink.close()


class NullRecorder:
    """Recording off: every operation is a no-op, spans never read the
    clock, metrics are shared no-op instruments."""
    enabled = False
    metrics = NULL_METRICS

    def scoped(self, *sinks):
        if not sinks:
            return self
        return Recorder(sinks)

    def run_meta(self, **data) -> None:
        pass

    def event(self, name: str, **data) -> None:
        pass

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def span_begin(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def span_end(self, sp) -> None:
        pass

    def flush_metrics(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_RECORDER = NullRecorder()

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_recorder", default=None)


def get_recorder():
    """The ambient recorder, or ``NULL_RECORDER`` when none installed."""
    rec = _ACTIVE.get()
    return rec if rec is not None else NULL_RECORDER


def set_recorder(rec) -> None:
    """Install ``rec`` (or None to clear) as the ambient recorder."""
    _ACTIVE.set(rec)


@contextmanager
def use_recorder(rec):
    """Scoped install: the ambient recorder inside the ``with`` block."""
    token = _ACTIVE.set(rec)
    try:
        yield rec
    finally:
        _ACTIVE.reset(token)


def active_recorder(verbose: bool = False, stream=None):
    """What runtimes call once per run: the ambient recorder, with a
    console sink attached when ``verbose`` (replacing the old raw
    ``print()`` paths — same text, now capturable through any sink)."""
    rec = get_recorder()
    if verbose:
        from repro_torch.obs.sinks import ConsoleSink
        rec = rec.scoped(ConsoleSink(stream))
    return rec
