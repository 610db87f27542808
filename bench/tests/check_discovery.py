"""Cells, configurations and metrics are found by name, with no code
edit, and ``BENCHMARK.json`` keeps to the benchmark's contract."""
import json
import re
import shutil

import pytest

from bench.tests.common import ROOT, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_new_cell_and_metric_files_are_found(tmp_path):
    bench = tmp_path / "bench"
    for d in ("workloads", "configs", "metrics", "drivers"):
        shutil.copytree(ROOT / "bench" / d, bench / d)
    cell = dict(spec.load_cell("cnn1000.fedcore-s30"), why="a throwaway")
    (bench / "workloads" / "throwaway.cell-1.json").write_text(
        json.dumps(cell))
    (bench / "metrics" / "throwaway.metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    assert "throwaway.cell-1" in spec.cell_names(bench)
    assert spec.load_cell("throwaway.cell-1", bench)["why"] == "a throwaway"
    assert spec.load_metric("throwaway.metric", bench).read(None) == 42.0
    bj = json.loads(json.dumps(BENCH))
    for m in bj["end_to_end"]:
        if "cnn1000.fedcore-s30" in m.get("workloads", ()):
            m["workloads"].append("throwaway.cell-1")
    bj["per_layer"].append({"name": "throwaway.metric", "unit": "%",
                            "better": "higher", "source": "device_trace",
                            "layer": "device", "moves": "round_s",
                            "workloads": ["throwaway.cell-1"]})
    got = spec.cell_metrics("throwaway.cell-1", bj)
    assert [m["name"] for m in got["per_layer"]] == ["throwaway.metric"]
    assert {m["name"] for m in got["end_to_end"]} == {"round_s", "setup_s"}


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        cfg = spec.load_config(c["name"])
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    chips4 = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        cell = spec.load_cell(w["name"])
        for k in ("config", "traffic", "chips", "why"):
            assert cell[k] == w[k], (w["name"], k)
        assert (ROOT / "bench" / "drivers" / f"{cell['entry']}.py").is_file()
        chips4 += w["chips"] == 4
        got = spec.cell_metrics(w["name"], BENCH)
        assert len(got["end_to_end"]) >= 2 and got["per_layer"]
    assert chips4 <= max(1, len(BENCH["workloads"]) // 4)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(spec.cell_names()) == cells    # no cell file left unlisted
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        for w in m.get("workloads", cells):     # each reports what it moves
            assert m["moves"] in {e["name"] for e in spec.cell_metrics(
                w, BENCH)["end_to_end"]}, (m["name"], w)
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", spec.cell_names())
def test_every_cell_file_names_a_configuration_and_a_driver(cell):
    c = spec.load_cell(cell)
    assert (ROOT / "bench" / "configs" / f"{c['config']}.json").is_file()
    assert (ROOT / "bench" / "drivers" / f"{c['entry']}.py").is_file()
    assert set(c["limits"]) and c["faults"]
