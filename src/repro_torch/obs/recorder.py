"""The Recorder: structured events + monotonic-clock spans + metrics.

Design constraints, in order:

1. **Determinism.**  Recording must never change what a runtime computes:
   the recorder reads ``time.perf_counter()`` and writes to sinks — it
   never touches RNG streams, never reorders events, never forces lazy
   arrays.  ``tests/test_obs.py`` holds byte-identical goldens per
   engine with recording on vs off.
2. **Zero cost when off.**  ``get_recorder()`` returns ``NULL_RECORDER``
   unless a recorder was installed; its spans are one shared no-op
   context manager (no clock reads) and its metrics are shared no-op
   instruments, so runtimes instrument unconditionally.
3. **Ambient, not threaded through.**  Runtimes call ``get_recorder()``
   instead of growing a ``recorder=`` parameter on every signature; the
   owner installs one with ``use_recorder(rec)`` / ``set_recorder``.

Spans nest via an explicit stack shared across ``scoped()`` views: each
emitted span record carries ``sid`` / ``parent`` / ``depth``, and both a
context-manager form (``with rec.span("eval"): ...``) and a manual form
(``span_begin`` / ``span_end``) exist — the async runtime needs manual
spans because its "round" is a record-window, not a lexical block.  With
``annotate=True`` every span also enters a
``torch.profiler.record_function`` range so profiler traces line up with
our phase names.
"""
from __future__ import annotations

import contextvars
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
    __slots__ = ("name", "sid", "parent", "depth", "t0", "attrs", "_ann")

    def __init__(self, name: str, sid: int, parent: Optional[int],
                 depth: int, t0: float, attrs: Dict[str, Any]) -> None:
        self.name = name
        self.sid = sid
        self.parent = parent
        self.depth = depth
        self.t0 = t0
        self.attrs = attrs
        self._ann = None


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


class _RunState:
    """Clock origin, sequence counter, span stack, and metrics — shared
    by a Recorder and every ``scoped()`` view of it."""
    __slots__ = ("clock", "t0", "seq", "stack", "metrics")

    def __init__(self, clock) -> None:
        self.clock = clock
        self.t0 = clock()
        self.seq = 0
        self.stack = []  # open Spans, innermost last
        self.metrics = MetricsRegistry()


class Recorder:
    """Emits run/span/event/metrics records to its sinks."""
    enabled = True

    def __init__(self, sinks: Sequence = (), annotate: bool = False,
                 clock=time.perf_counter, _state: Optional[_RunState] = None):
        self._sinks = tuple(sinks)
        self._annotate = bool(annotate)
        self._state = _state if _state is not None else _RunState(clock)

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

    def _emit(self, record: dict) -> None:
        for sink in self._sinks:
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
            from torch.profiler import record_function
            sp._ann = record_function(name)
            sp._ann.__enter__()
        st.stack.append(sp)
        return sp

    def span_end(self, sp: Span) -> None:
        t1 = self._now()
        if sp._ann is not None:
            sp._ann.__exit__(None, None, None)
            sp._ann = None
        st = self._state
        # tolerate a mis-nested end by unwinding to the span being closed
        while st.stack and st.stack[-1] is not sp:
            st.stack.pop()
        if st.stack:
            st.stack.pop()
        self._emit({"v": SCHEMA_VERSION, "kind": "span",
                    "seq": self._next_seq(), "t": sp.t0, "name": sp.name,
                    "t0": sp.t0, "t1": t1, "dur": t1 - sp.t0,
                    "sid": sp.sid, "parent": sp.parent, "depth": sp.depth,
                    "attrs": dict(sp.attrs)})

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
        record (also done by ``close``)."""
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
