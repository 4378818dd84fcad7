"""The reader of the batch decode's copy to the host
(`metrics/decode.d2h_mb.batch.py`) against hand-made spans, as
`test_pb_spans.py` holds the other readers of the program's spans."""

from types import SimpleNamespace

import pytest

from port_bench import harness, spans
from port_bench.test_pb_spans import MS, run_of, span

METRIC = "decode.d2h_mb.batch"


def test_the_mean_over_the_windows_batches_in_mb(monkeypatch):
    raw = [span("decode.batch", 0, 100 * MS, **{"decode.d2h_bytes": 768_000}),
           span("decode.rebuild", 60 * MS, 90 * MS),
           span("decode.batch", 200 * MS, 300 * MS, **{"decode.d2h_bytes": 500_000}),
           span("decode.batch", 500 * MS, 600 * MS, **{"decode.d2h_bytes": 9_000_000})]
    run = run_of(monkeypatch, raw, [("k5", 0, MS)], 0, 400 * MS)
    # the third batch lies past the window's end
    assert harness.load_metric(METRIC).read(run) == pytest.approx(0.634)


def test_batches_without_the_counter_read_nothing(monkeypatch):
    """A program whose decode does not count its copy (the parent of this
    reader) reads nothing and raises nothing."""
    raw = [span("decode.batch", 0, 100 * MS), span("decode.unpack", 40 * MS, 55 * MS)]
    run = run_of(monkeypatch, raw, [("k5", 0, MS)], 0, 400 * MS)
    assert harness.load_metric(METRIC).read(run) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert harness.load_metric(METRIC).read(SimpleNamespace(trace_data=None)) is None
