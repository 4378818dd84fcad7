"""The manifest against the contract's shape, and the discovery of every
piece by its name."""

import json
import os
import re

import pytest

from port_bench import generator, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.manifest()


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_configs_are_files_under_paths():
    for c in BENCH["configs"]:
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        cfg = generator.load_json("configs", c["name"])
        assert set(c["reduced"]) <= set(cfg["reduced"])
        assert cfg["source"] == c["source"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_and_metrics(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    workload = generator.load_json("workloads", cell)
    assert (workload["config"], workload["traffic"]) == (entry["config"], entry["traffic"])
    traffic = generator.load_json("traffic", workload["traffic"])
    driver = harness.driver(traffic)
    for fn in ("setup", "window", "release", "reference", "program", "numbers", "readings",
               "variant"):
        assert callable(getattr(driver, fn))
    name = driver.__name__
    tiny = getattr(driver, "TINY", None)
    assert isinstance(tiny, dict) and {"traffic", "cfg", "limits"} <= set(tiny), \
        f"{name} has no TINY with traffic, cfg and limits (the CPU tests' cut)"
    assert set(tiny["limits"]) == set(workload["limits"]), \
        f"{name}'s TINY limits {sorted(tiny['limits'])} are not {cell}'s {sorted(workload['limits'])}"
    assert getattr(driver, "FAULTS", None), f"{name} plants no fault (FAULTS)"
    e2e = harness.cell_metrics(BENCH, cell, "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_files_declare_what_the_manifest_says(metric):
    module = harness.load_metric(metric["name"])
    assert module.UNIT == metric["unit"] and module.SOURCE == metric["source"]
    assert callable(module.read)
    if "layer" in metric:
        assert module.LAYER == metric["layer"] and module.MOVES == metric["moves"]
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved["workloads"])


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_file_under_paths_is_named_from_name_characters():
    root = harness.HERE
    for folder, _, files in os.walk(root):
        if "__pycache__" in folder:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(folder, f), os.path.dirname(root))
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
