"""Counters, gauges, and histograms with one canonical snapshot shape.

Instruments are created on demand (``registry.counter("dispatches")``)
and are plain ``__slots__`` objects so the recording-on hot path is a
dict lookup plus an attribute add.  ``NULL_METRICS`` is the recording-off
twin: every accessor returns one shared no-op instrument, so runtimes can
instrument unconditionally without guarding on a recorder being active.

Snapshot shape (the ``data`` field of a ``kind="metrics"`` record)::

    {"counters":   {name: number},
     "gauges":     {name: number},
     "histograms": {name: {"count": int, "sum": float,
                           "min": float, "max": float,
                           "buckets": {label: int}}}}

Histograms bucket by powers of two by default (``le_2``, ``le_4``, ...)
— right for durations and byte counts spanning orders of magnitude — or
exactly by integer value with ``exact=True`` (right for staleness).
"""
from __future__ import annotations

import math
from typing import Dict


class Counter:
    """A monotonically increasing number (int or float)."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """A last-value-wins number."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Count/sum/min/max plus bucket counts.

    ``exact=True`` buckets by exact integer value (small discrete
    domains: staleness, epochs); the default buckets by the smallest
    power of two >= the value, labelled ``le_<bound>``.
    """
    __slots__ = ("count", "total", "vmin", "vmax", "buckets", "exact")

    def __init__(self, exact: bool = False) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets: Dict[str, int] = {}
        self.exact = exact

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if self.exact:
            label = str(int(v))
        elif v <= 0.0:
            label = "le_0"
        else:
            label = f"le_{2.0 ** math.ceil(math.log2(v)):g}"
        self.buckets[label] = self.buckets.get(label, 0) + 1

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "buckets": dict(self.buckets),
        }


class MetricsRegistry:
    """Name -> instrument maps with on-demand creation."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, exact: bool = False) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(exact=exact)
        return h

    def snapshot(self) -> dict:
        return {
            "counters": {k: v.value for k, v in self._counters.items()},
            "gauges": {k: v.value for k, v in self._gauges.items()},
            "histograms": {k: v.snapshot()
                           for k, v in self._histograms.items()},
        }


class _NullInstrument:
    """Accepts inc/set/observe and drops them; reads as zero."""
    __slots__ = ()
    value = 0

    def inc(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class _NullMetrics:
    """Recording-off registry: every instrument is the shared no-op."""
    __slots__ = ()

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, exact: bool = False) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}


NULL_METRICS = _NullMetrics()
