"""BENCHMARK.json as the benchmark's contract has it, and every file that
a cell, a mix or a metric names found by its name."""

import json
import os
import re

import pytest

import run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_and_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("bench_port/") and os.path.exists(os.path.join(run.ROOT, c["file"]))
        assert json.load(open(os.path.join(run.ROOT, c["file"])))["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in BENCH["end_to_end"] + BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_and_reports_enough(cell):
    _, _, traffic = run.load_cell(BENCH, cell)
    assert os.path.exists(os.path.join(run.HERE, "units", traffic["unit"] + ".py"))
    e2e = run.cell_metrics(BENCH, cell, trace=False)
    layer = run.cell_metrics(BENCH, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in {x["name"] for x in e2e}  # each per-layer metric's cell reports what it moves


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_each_metric_has_its_reader(metric):
    reader = run.load_module(os.path.join(run.HERE, "metrics", metric + ".py"), "m_" + metric.replace(".", "_"))
    assert callable(reader.read)


def test_files_under_paths_are_named_from_name_characters():
    for root, dirs, files in os.walk(run.HERE):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build", "_cache")]
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), run.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_missing_metric_reader_or_cell_is_an_error():
    with pytest.raises(FileNotFoundError):
        run.load_module(os.path.join(run.HERE, "metrics", "no_such_metric.py"), "m_none")
    with pytest.raises(SystemExit):
        run.load_cell(BENCH, "no-such.cell")
