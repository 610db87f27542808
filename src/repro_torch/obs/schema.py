"""The canonical record schema shared by every runtime, plus validators.

Envelope (every record): ``v`` (schema version), ``kind`` (one of
``run`` / ``span`` / ``event`` / ``metrics``), ``seq`` (emission order,
unique per run), ``t`` (seconds since the recorder's clock origin).

Kinds:

* ``run``    — ``data`` describes the run: at least ``runtime`` (one of
  ``sync`` / ``async`` / ``fleet`` / ``async_fleet``) and ``engine``.
* ``span``   — a closed phase span: ``name``, ``sid``, ``parent`` (sid
  or None), ``depth``, ``t0 <= t1``, ``dur``, free-form ``attrs``, and
  ``dev_s``: the span's stream time in seconds, or None without CUDA.
* ``event``  — a named point event with a ``data`` dict.  Two names are
  canonical and validated strictly so loop/batched/sharded/sync/async
  runs are directly comparable:

  - ``round``   — one per completed round/record-window, fields
    ``ROUND_REQUIRED`` below (identical across all five runtimes; a
    runtime may add extras like ``applied`` / ``t_virtual``).
  - ``clients`` — per-round straggler diagnostics: aligned ``cids`` /
    ``durations`` lists (sim seconds of busy time per participant).

* ``metrics`` — a MetricsRegistry snapshot (see ``repro.obs.metrics``).

``validate_records`` additionally checks run-level span invariants:
unique sids, parents that exist and strictly contain their children in
time, and depth consistency.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Sequence

KINDS = ("run", "span", "event", "metrics")

# canonical per-round schema — every runtime emits exactly these fields
# (plus free extras) so cross-runtime comparison needs no translation
ROUND_REQUIRED: Dict[str, tuple] = {
    "runtime": (str,),            # "sync" | "async" | "fleet" | "async_fleet"
    "engine": (str,),             # sync|async|loop|batched|sharded
    "label": (str,),              # console tag, e.g. "fedcore", "fleet/batched"
    "round": (int,),
    "n_participants": (int,),
    "n_dropped": (int,),
    "n_coreset": (int,),
    "n_violations": (int,),
    "sim_round_time": (int, float),
    "wall_time_s": (int, float),
    "train_loss": (int, float),
    "test_acc": (int, float),
    "test_loss": (int, float),
}

CLIENTS_REQUIRED: Dict[str, tuple] = {
    "round": (int,),
    "cids": (list,),
    "durations": (list,),
}

RUNTIMES = ("sync", "async", "fleet", "async_fleet")

# the phase-span vocabulary runtimes draw from (report orders columns by
# first appearance, so this is documentation + test reference, not a gate)
PHASES = ("cohort_build", "cohort_select", "local_update", "local_sgd",
          "grad_features", "distances", "selection", "coreset_group",
          "coreset_epochs", "dispatch", "gather", "aggregate",
          "trace_account", "eval", "buffer_fill", "dispatch_wave",
          "checkpoint", "lm_init", "sgd_steps", "kmedoids_build",
          "kmedoids_swap")


def _fail(msg: str, record: dict) -> None:
    raise ValueError(f"obs schema: {msg}: {record!r}")


def _check_fields(data: dict, required: Dict[str, tuple],
                  record: dict, what: str) -> None:
    for field, types in required.items():
        if field not in data:
            _fail(f"{what} missing field {field!r}", record)
        v = data[field]
        # bool is an int subclass but never a sanctioned numeric here
        if not isinstance(v, types) or isinstance(v, bool):
            _fail(f"{what} field {field!r} has type "
                  f"{type(v).__name__}, wanted {types}", record)


def validate_record(record: dict) -> None:
    """Raise ValueError unless ``record`` matches the canonical schema."""
    if not isinstance(record, dict):
        raise ValueError(f"obs schema: record is not a dict: {record!r}")
    for field in ("v", "kind", "seq", "t"):
        if field not in record:
            _fail(f"missing envelope field {field!r}", record)
    kind = record["kind"]
    if kind not in KINDS:
        _fail(f"unknown kind {kind!r}", record)
    if not isinstance(record["seq"], int) or isinstance(record["seq"], bool):
        _fail("seq is not an int", record)
    if not isinstance(record["t"], (int, float)):
        _fail("t is not a number", record)

    if kind == "run":
        data = record.get("data")
        if not isinstance(data, dict):
            _fail("run record has no data dict", record)
        if data.get("runtime") not in RUNTIMES:
            _fail(f"run runtime {data.get('runtime')!r} not in {RUNTIMES}",
                  record)
        if not isinstance(data.get("engine"), str):
            _fail("run record missing engine", record)

    elif kind == "span":
        for field in ("name", "sid", "t0", "t1", "dur", "depth"):
            if field not in record:
                _fail(f"span missing {field!r}", record)
        if not isinstance(record.get("attrs"), dict):
            _fail("span attrs is not a dict", record)
        if record["t1"] < record["t0"]:
            _fail("span ends before it starts", record)
        if not math.isclose(record["dur"], record["t1"] - record["t0"],
                            rel_tol=1e-9, abs_tol=1e-9):
            _fail("span dur != t1 - t0", record)
        dev_s = record.get("dev_s")
        if dev_s is not None and (not isinstance(dev_s, (int, float))
                                  or isinstance(dev_s, bool) or dev_s < 0):
            _fail("span dev_s is not a non-negative number or None", record)

    elif kind == "event":
        name = record.get("name")
        if not isinstance(name, str):
            _fail("event has no name", record)
        data = record.get("data")
        if not isinstance(data, dict):
            _fail("event has no data dict", record)
        if name == "round":
            _check_fields(data, ROUND_REQUIRED, record, "round event")
            if data["runtime"] not in RUNTIMES:
                _fail(f"round runtime {data['runtime']!r}", record)
        elif name == "clients":
            _check_fields(data, CLIENTS_REQUIRED, record, "clients event")
            if len(data["cids"]) != len(data["durations"]):
                _fail("clients cids/durations misaligned", record)

    elif kind == "metrics":
        data = record.get("data")
        if not isinstance(data, dict):
            _fail("metrics record has no data dict", record)
        for section in ("counters", "gauges", "histograms"):
            if not isinstance(data.get(section), dict):
                _fail(f"metrics record missing {section!r}", record)


def validate_records(records: Sequence[dict]) -> None:
    """Per-record validation plus run-level span-nesting invariants."""
    spans = []
    seqs = set()
    for record in records:
        validate_record(record)
        seq = record["seq"]
        if seq in seqs:
            _fail("duplicate seq", record)
        seqs.add(seq)
        if record["kind"] == "span":
            spans.append(record)

    by_sid = {}
    for sp in spans:
        if sp["sid"] in by_sid:
            _fail("duplicate span sid", sp)
        by_sid[sp["sid"]] = sp
    for sp in spans:
        parent = sp.get("parent")
        if parent is None:
            continue
        if parent not in by_sid:
            _fail(f"span parent sid {parent} never emitted", sp)
        pa = by_sid[parent]
        if sp["depth"] != pa["depth"] + 1:
            _fail("span depth is not parent depth + 1", sp)
        if sp["t0"] < pa["t0"] or sp["t1"] > pa["t1"]:
            _fail("span not contained in its parent's interval", sp)


def read_jsonl(path: str) -> List[dict]:
    """Load a JSONL run log (skipping blank lines)."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records
