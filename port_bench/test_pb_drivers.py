"""Each traffic mix run at a tiny size on the CPU through the harness, as a
run drives it (without the look for a card): sound, it comes out correct;
with the timed path broken underneath in each way the cell can be, and
with the control in the program's place, it does not."""

import contextlib
import time

import pytest
import torch

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


def _unchanged(real):
    def update(state, batch, seed):
        kept = [p.detach().clone() for p in state.model.parameters()]
        metrics = real(state, batch, seed)
        with torch.no_grad():
            for p, k in zip(state.model.parameters(), kept):
                p.copy_(k)
        return metrics
    return update


def _half_batch(real):
    def update(state, batch, seed):
        rows = batch.features.shape[0] // 2
        return real(state, type(batch)(*(t[:rows] for t in batch)), seed)
    return update


def _altered(real):
    def rebuild(*args, **kw):
        out = real(*args, **kw)
        return [r._replace(tokens=[r.tokens[0] ^ 1] + list(r.tokens[1:])) if r.tokens else r
                for r in out]
    return rebuild


FAULTS = [(c, f) for c in CELLS if c.endswith("train-b512") for f in ("unchanged", "half_batch")]
FAULTS += [(c, "altered_token") for c in CELLS if not c.endswith("train-b512")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_timed_path_is_not_correct(cell, fault):
    import stt_tpu_torch.decode.device as decode_device
    import stt_tpu_torch.train.step as train_step

    where = {"unchanged": (train_step, "_update", _unchanged),
             "half_batch": (train_step, "_update", _half_batch),
             "altered_token": (decode_device, "rebuild_results", _altered)}[fault]
    with patched(*where):
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
