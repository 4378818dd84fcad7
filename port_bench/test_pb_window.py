"""The window's statistics: a rate counts the whole steps (or batches) that
ended in the window and ends at the last of them; a tail is taken over
every piece or stream due in the window."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import harness, tiny
from port_bench.drivers import batch, pool, train

STEP_S = 0.3


def _records(driver, cell: str, ctx: dict, seconds: float) -> dict:
    run = tiny.run(cell, seconds=seconds)
    driver.window(run, ctx, seconds)
    return run.records, run


def test_train_rate_ends_at_the_last_whole_step():
    def step(state, batch_, seed):
        time.sleep(STEP_S)
        return state, SimpleNamespace(non_finite=torch.zeros(2, dtype=torch.bool))

    ctx = {"state": None, "step": step, "batches": [0, 1], "audio_s": [10.0, 20.0],
           "frames": [100, 200]}
    r, run = _records(train, "en-train-b512", ctx, 1.0)
    # steps end at ~0.3, 0.6, 0.9 and 1.2 s: the fourth ends past the window
    assert r["steps"] == 3
    # the window's first step is step compare_steps = 3: batches 1, 0, 1
    assert r["audio_s"] == 50.0 and r["frames"] == 500
    assert r["window_end"] - r["window_start"] == pytest.approx(3 * STEP_S, abs=0.05)
    rate = harness.load_metric("train_audio_s_per_s").read(run)
    assert rate == pytest.approx(50.0 / (3 * STEP_S), rel=0.05)


def test_transcription_rate_ends_at_the_last_whole_batch(monkeypatch):
    monkeypatch.setattr(batch, "_transcribe", lambda run, ctx, k: time.sleep(STEP_S))
    ctx = {"batches": [{"audio_s": 7.0, "lengths": [3, 4], "audio": torch.zeros(2, 10)}] * 2}
    r, run = _records(batch, "en-batch-devdecode", ctx, 1.0)
    assert r["audio_s"] == 21.0 and r["attempted"] == 3 * 3
    assert harness.load_metric("transcribe_audio_s_per_s").read(run) == pytest.approx(
        21.0 / (3 * STEP_S), rel=0.05)


def test_p95_is_over_every_sample():
    lat = list(np.linspace(0.1, 1.0, 200)) + [5.0] * 20
    run = SimpleNamespace(records={"piece_latencies": lat, "final_latencies": lat[:40]})
    assert harness.load_metric("chunk_p95_ms").read(run) == pytest.approx(
        1e3 * np.percentile(lat, 95))
    assert harness.load_metric("final_p95_ms").read(run) == pytest.approx(
        1e3 * np.percentile(lat[:40], 95))


def test_pool_counts_every_piece_due_in_the_window():
    run = tiny.run("en-pool-devdecode", seconds=2.0)
    run.records["started"] = time.perf_counter()
    _, ctx = harness.measure(run)
    r = run.records
    deadline = r["window_end"]
    due = [d for s in ctx["streams"] for d in s.due if d is not None and d < deadline]
    assert r["attempted"] == len(due) == len(r["piece_latencies"]) and r["failed"] == 0
    # every stream of the window finished with its transcript, timed from its last piece
    finished = [s for s in ctx["streams"] if s.final and s.final[0] is not None
                and s.final[0] < deadline]
    assert len(r["final_latencies"]) == len(finished) > 0
    # a piece waits at least for the round that emits it, which needs the next piece
    assert min(r["piece_latencies"]) >= 0
    assert pool.program(run, ctx)
