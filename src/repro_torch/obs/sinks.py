"""Sinks: where Recorder records go.

``InMemorySink`` keeps raw record dicts (tests and programmatic use),
``JSONLSink`` writes one JSON object per line (runs; numpy values are
converted at the serialization boundary only — the in-process records
are never mutated), and ``ConsoleSink`` renders the canonical ``round``
event as the exact text the runtimes' old ``verbose`` prints produced,
so ``verbose=True`` output is now capturable and testable through any
stream.
"""
from __future__ import annotations

import json
import sys
from typing import IO, List, Optional

import numpy as np


class Sink:
    """Sink interface: ``emit(record)`` per record, ``close()`` once."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemorySink(Sink):
    """Collects raw record dicts in ``records``."""

    def __init__(self) -> None:
        self.records: List[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)


def _jsonify(obj):
    """json.dumps default hook: numpy scalars/arrays to plain python."""
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


class JSONLSink(Sink):
    """One JSON object per line at ``path`` (created/truncated)."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        self._fh: Optional[IO[str]] = open(self.path, "w")

    def emit(self, record: dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(record, default=_jsonify) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# per-runtime round-event formats — byte-for-byte the text the old
# inline ``print()`` calls in server.py / events.py / fleet/batched.py
# produced, keyed by the canonical event's ``runtime`` field
def _fmt_sync(d: dict) -> str:
    return (f"[{d['label']}] round {d['round']:3d} "
            f"time {d['sim_round_time']:8.1f}s loss {d['train_loss']:.4f} "
            f"acc {d['test_acc']:.4f} (core {d['n_coreset']}, "
            f"drop {d['n_dropped']})")


def _fmt_async(d: dict) -> str:
    return (f"[{d['label']}] "
            f"update {d['applied']:4d} t={d['t_virtual']:9.1f}s "
            f"loss {d['train_loss']:.4f} acc {d['test_acc']:.4f} "
            f"(core {d['n_coreset']}, drop {d['n_dropped']})")


def _fmt_fleet(d: dict) -> str:
    return (f"[{d['label']}] round {d['round']:3d} "
            f"cohort {d['n_participants']:5d} "
            f"core {d['n_coreset']:5d} time {d['sim_round_time']:9.1f}s "
            f"loss {d['train_loss']:.4f} acc {d['test_acc']:.4f}")


def _fmt_async_fleet(d: dict) -> str:
    return (f"[{d['label']}] flush {d['round']:4d} "
            f"t={d['t_virtual']:9.1f}s merged {d['n_participants']:4d} "
            f"core {d['n_coreset']:4d} loss {d['train_loss']:.4f} "
            f"acc {d['test_acc']:.4f}")


ROUND_FORMATS = {"sync": _fmt_sync, "async": _fmt_async, "fleet": _fmt_fleet,
                 "async_fleet": _fmt_async_fleet}


class ConsoleSink(Sink):
    """Renders ``round`` events as the runtimes' historical verbose text."""

    def __init__(self, stream: Optional[IO[str]] = None) -> None:
        self._stream = stream

    def emit(self, record: dict) -> None:
        if record.get("kind") != "event" or record.get("name") != "round":
            return
        data = record.get("data", {})
        fmt = ROUND_FORMATS.get(data.get("runtime"))
        if fmt is None:
            return
        print(fmt(data), file=self._stream or sys.stdout)  # noqa: lint-noprint (the console sink IS the sanctioned print)
