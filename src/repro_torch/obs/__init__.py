"""Unified observability layer shared by every FL runtime.

FedCore's claim is a *time* claim — an 8x wall-clock cut from eliminating
stragglers — so the repo needs one instrumentation layer that can answer
"where did round r spend its time, and which clients dragged it" for the
sync server, the async event engine, and all three fleet engines, from
one schema.  This package provides:

  * ``Recorder`` (``repro.obs.recorder``) — cheap structured events,
    monotonic-clock spans for the round phases (cohort build, local SGD,
    selection, coreset epochs, gather, aggregation, eval, ...), and a
    ``torch.profiler`` range bridge so profiler traces line up with our
    spans.  Where CUDA runs, each span also carries ``dev_s``,
    its stream time from CUDA events recorded at its begin and end (the
    stream's waits for the host inside it included); they are read once
    the outermost span ends, the recorder's one wait;
  * a metrics registry (``repro.obs.metrics``) — counters / gauges /
    histograms: dispatches, program-cache hits/misses/recompiles,
    per-client busy time, deadline-violation and staleness histograms,
    bytes moved per aggregation;
  * pluggable sinks (``repro.obs.sinks``) — in-memory (tests), JSONL
    file (runs), and a console sink that renders the canonical round
    event as the exact text the runtimes' old ``verbose`` prints
    produced;
  * the canonical record schema + validators (``repro.obs.schema``) —
    one "round" event shape emitted by every runtime so sync / async /
    loop / batched / sharded runs are directly comparable, rendered by
    the JAX package's ``benchmarks/report.py``.

Recording is ambient: runtimes call ``get_recorder()`` and get either
the recorder installed with ``use_recorder`` / ``set_recorder`` or a
zero-cost ``NullRecorder``.  Recording never touches RNG streams, event
ordering, or numerics.  Span and event names are the JAX package's, so
its schema validates the port's logs too.
"""
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.recorder import (NULL_RECORDER, NullRecorder, Recorder,
                                      SCHEMA_VERSION, active_recorder,
                                      get_recorder, set_recorder,
                                      use_recorder)
from repro_torch.obs.sinks import ConsoleSink, InMemorySink, JSONLSink
from repro_torch.obs.schema import read_jsonl, validate_record, validate_records

__all__ = [
    "Recorder", "NullRecorder", "NULL_RECORDER", "SCHEMA_VERSION",
    "get_recorder", "set_recorder", "use_recorder", "active_recorder",
    "MetricsRegistry", "ConsoleSink", "InMemorySink", "JSONLSink",
    "read_jsonl", "validate_record", "validate_records",
]
