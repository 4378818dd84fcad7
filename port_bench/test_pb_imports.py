"""What the harness loads: nothing of JAX or of the JAX package in a run,
and nothing of the program in the reference. Module names are compared by
their top-level part, whole: `stt_tpu_torch` is not `stt_tpu`."""

import ast
import json
import os
import subprocess
import sys

from port_bench import harness

ROOT = harness.ROOT
PROGRAM = "stt_tpu_torch"


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    for folder, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(folder, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_the_yardstick_and_the_reference_import_nothing_of_the_program():
    fixed = [os.path.join(harness.HERE, "reference", f)
             for f in os.listdir(os.path.join(harness.HERE, "reference")) if f.endswith(".py")]
    fixed += [os.path.join(harness.HERE, f) for f in ("yardstick.py", "generator.py")]
    for path in fixed:
        assert PROGRAM not in _imports(path), path


def test_forbidden_names_compare_whole():
    mods = {"stt_tpu_torch.ops": 1, "stt_tpu_torchx": 1, "jaxlib_like": 1}
    assert not [m for m in mods if m.split(".")[0] in harness.FORBIDDEN]
    assert ["stt_tpu.x"] == [m for m in ["stt_tpu.x", "stt_tpu_torch.x"]
                             if m.split(".")[0] in harness.FORBIDDEN]


SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
from port_bench import harness, tiny
loaded = {{}}
for cell in {cells!r}:
    run = tiny.run(cell, seconds=0.5)
    run.records["started"] = time.perf_counter()
    drv, ctx = harness.measure(run)
    drv.release(ctx)
    drv.readings(run, ctx)
    for m in harness.cell_metrics(harness.manifest(), cell, "end_to_end"):
        harness.load_metric(m["name"]).read(run)
    loaded[cell] = harness.forbidden_modules()
print(json.dumps(loaded))
"""

REFERENCE_ONLY = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import port_bench.reference, port_bench.yardstick
found = [m.name for m in pkgutil.walk_packages(port_bench.reference.__path__, "port_bench.reference.")]
if not found:
    sys.exit("no module under port_bench/reference/")
for name in found:
    importlib.import_module(name)
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in ("stt_tpu_torch", "stt_tpu"))))
"""


def test_a_run_of_every_cell_loads_nothing_forbidden():
    cells = [w["name"] for w in harness.manifest()["workloads"]]
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT, cells=cells)],
                         capture_output=True, text=True, timeout=600, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded == {cell: [] for cell in cells}


def test_the_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", REFERENCE_ONLY.format(root=ROOT)],
                         capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
