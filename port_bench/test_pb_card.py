"""On the card only: one short run of each cell through the command, as the
benchmark's check runs it, whose last line must be a correct result with
the cell's metrics; and one with each fault that the cell's driver plants
in the program, which must not be correct."""

import json
import subprocess
import sys

import pytest

from port_bench import harness

BENCH = harness.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
                          "4294967311", "--seconds", "4", "--trace", str(trace)],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.cell_metrics(BENCH, cell, section)}
    assert set(result["metrics"]) == want
    device = result["device"]
    assert device["platform"] == "gpu" and device["count"] == 1
    if trace:
        assert 0 < device["busy_s"] <= device["window_s"] and result["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in harness.cell_driver(c).FAULTS])
def test_a_run_with_a_planted_fault_is_not_correct(card, cell, fault):
    out = subprocess.run([sys.executable, "port_bench/planted.py", "--fault", fault,
                          "--workload", cell, "--seed", "4294967311", "--seconds", "4",
                          "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert not result["correct"], result["checks"]
