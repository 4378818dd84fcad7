"""Each traffic mix run at a tiny size on the CPU through the harness, as a
run drives it (without the look for a card): sound, it comes out correct;
with the timed path broken underneath in each way the cell can be, and
with the control in the program's place, it does not."""

import contextlib
import importlib
import time

import pytest

from port_bench import harness, tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@contextlib.contextmanager
def patched(module, name: str, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def drive(cell: str):
    """A run's set-up, window and comparison: (correct, checks, run, ctx)."""
    run = tiny.run(cell)
    run.records["started"] = time.perf_counter()
    drv, ctx = harness.measure(run)
    drv.release(ctx)
    checks = harness.checks_of(drv.readings(run, ctx), run.limits())
    correct = all(v <= lim for v, lim in checks.values()) and run.records["failed"] == 0
    return correct, checks, run, ctx


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    correct, checks, run, _ = drive(cell)
    assert correct, checks
    assert run.records["attempted"] > 0
    assert set(checks) == set(run.limits())


# each cell with each fault that its mix's driver plants in the program
FAULTS = [(c, f) for c in CELLS for f in harness.cell_driver(c).FAULTS]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_timed_path_is_not_correct(cell, fault):
    module, name, make = harness.cell_driver(cell).FAULTS[fault]
    with patched(importlib.import_module(module), name, make):
        correct, checks, _, _ = drive(cell)
    assert not correct, checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference one precision below (TF32 operands) in the program's
    place fails one of the cell's limits."""
    run = tiny.run(cell)
    run.records["started"] = time.perf_counter()
    drv, ctx = harness.measure(run)
    drv.release(ctx)
    want = drv.reference(run, ctx)
    numbers = drv.variant(run, ctx, "tf32", want)
    checks = harness.checks_of(numbers, run.limits())
    assert any(v > lim for v, lim in checks.values()), checks
