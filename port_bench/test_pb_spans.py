"""The readers of the program's spans (`spans.py` and the six metrics that
read it) against hand-made traces and spans, with every number worked out
by hand. Times are nanoseconds; the spans' perf_counter times move onto the
trace's clock by the anchor."""

from types import SimpleNamespace

import pytest

from port_bench import harness, spans

BASE = 10 ** 12  # the anchor's time reading; its perf reading is 0
ANCHOR = {"time": BASE, "monotonic": BASE // 2, "perf": 0}
MS = 10 ** 6


def span(name, start, end, parent=None, marks=None, launched=None, **counters):
    """A recorded span as the tracer keeps it, on the perf clock (which the
    anchor puts BASE behind the trace's): `marks` numbers its entry and exit
    markers, whose launches end at `launched` (by default its start and
    end) and begin 10 us before."""
    if marks is not None:
        marks = tuple((n, t - 10_000, t) for n, t in zip(marks, launched or (start, end)))
    return SimpleNamespace(name=name, start=start, end=end, parent=parent,
                           marks=marks, counters=counters, attrs={})


def run_of(monkeypatch, raw, intervals, lo, hi):
    monkeypatch.setattr(spans, "recorded", lambda: (raw, ANCHOR) if raw else None)
    data = {"intervals": [(n, BASE + s, BASE + e) for n, s, e in intervals],
            "lo": BASE + lo, "hi": BASE + hi}
    return SimpleNamespace(trace_data=data)


def ms(x):
    return round(x * MS)


def marker(start_ms):
    return ("at::cuda::(anonymous namespace)::spin_kernel(long)", ms(start_ms),
            ms(start_ms + 0.001))


# One train step (ms): the step's markers (0, 5), the loss's (1, 2) and its
# backward's (3, 4), the loss's exit and the backward's entry adjacent.
# Device operations A in the forward, B in the loss, E on another stream
# across both of the loss's windows, C in its backward, D in the optimizer.
# Markers launched on an idle card run at once; the loss's exit and the
# backward's entry wait behind B and E.
TRAIN_OPS = [marker(100), ("A", ms(110), ms(190)), marker(200), ("B", ms(210), ms(290)),
             ("E", ms(280), ms(320)), marker(300), marker(302), ("C", ms(310), ms(390)),
             marker(400), ("D", ms(420), ms(480)), marker(500)]


def train_spans(k=0):
    """The spans of step k, 1000 ms after step k - 1."""
    t, n = 1000 * k, 6 * k
    step = span("train.step", ms(t + 99.995), ms(t + 499.985), marks=(n, n + 5),
                launched=(ms(t + 99.99), ms(t + 499.99)))
    return [step,
            span("train.forward", ms(t + 99.996), ms(t + 190), step),
            span("ctc.loss", ms(t + 199.995), ms(t + 259.99), step, marks=(n + 1, n + 2),
                 launched=(ms(t + 199.99), ms(t + 260))),
            span("ctc.loss.bwd", ms(t + 262.005), ms(t + 399.985), step, marks=(n + 3, n + 4),
                 launched=(ms(t + 262), ms(t + 399.99))),
            span("train.backward", ms(t + 262.01), ms(t + 450), step),
            span("train.optim", ms(t + 455), ms(t + 499.98), step)]


def train_ops(k=0):
    return [(name, s + ms(1000 * k), e + ms(1000 * k)) for name, s, e in TRAIN_OPS]


def test_ctc_share_counts_each_moment_once(monkeypatch):
    run = run_of(monkeypatch, train_spans(), TRAIN_OPS, 0, ms(1000))
    # the loss's windows [200.001, 300] and [302.001, 400] hold B u E u C =
    # [210, 390]: 90 + 87.999; the step's window [100.001, 500] holds A 80,
    # [210, 390] 180 and D 60
    assert harness.load_metric("ctc.share.train").read(run) == pytest.approx(
        100 * 177.999 / 320)


def test_ctc_idle_is_the_gaps_while_the_host_is_in_the_loss(monkeypatch):
    run = run_of(monkeypatch, train_spans(), TRAIN_OPS, 0, ms(1000))
    # gaps of the union: ... [190, 200], [200.001, 210], [390, 400], ...; the
    # host in the loss over [199.995, 259.99] and [262.005, 399.985]:
    # 0.005 + 9.999 + 9.985
    assert harness.load_metric("ctc.idle.train").read(run) == pytest.approx(100 * 19.989 / 1000)


MARKERS_MS = [100, 200, 300, 302, 400, 500]  # TRAIN_OPS's markers


@pytest.mark.parametrize("lost", [0, 2, 5], ids=["entry", "loss_exit", "exit"])
def test_a_lost_marker_leaves_out_only_its_step(monkeypatch, lost):
    """Step 1 of three lacks one marker. The card's idle gaps of 1 ms or
    more with no launch within the clocks' error cut the markers between
    the steps; a launch inside such a gap lost its marker. Steps 0 and 2
    pair and are read, step 1 not."""
    missing = ms(1000 + MARKERS_MS[lost])
    raw = [s for k in range(3) for s in train_spans(k)]
    ops = [op for k in range(3) for op in train_ops(k) if op[1] != missing]
    run = run_of(monkeypatch, raw, ops, 0, ms(3000))
    got = spans.window_spans(run)
    windows = spans.device_windows(got, run.trace_data)
    # the spans with markers are 0 (train.step), 2 (ctc.loss), 3 (ctc.loss.bwd)
    assert {i for i in windows if i < 6} == {i - 12 for i in windows if i >= 12} == {0, 2, 3}
    assert not any(6 <= i < 12 for i in windows)
    assert windows[0] == (BASE + ms(100.001), BASE + ms(500))
    assert windows[12] == (BASE + ms(2100.001), BASE + ms(2500))
    steps, loss, n_steps = spans.step_windows(got, run.trace_data, "train.step",
                                              ("ctc.loss", "ctc.loss.bwd"))
    assert (len(steps), len(loss), n_steps) == (2, 4, 3)
    assert harness.load_metric("ctc.share.train").read(run) == pytest.approx(
        100 * 177.999 / 320)


def test_markers_pair_across_the_clocks_drift(monkeypatch):
    """The trace's clock 7.2 ms behind the host's mapping, as on a card 20 s
    into a window: the markers seem to run before their launches, and pair."""
    ops = [(name, s - ms(7.2), e - ms(7.2)) for name, s, e in TRAIN_OPS]
    run = run_of(monkeypatch, train_spans(), ops, 0, ms(1000))
    assert harness.load_metric("ctc.share.train").read(run) == pytest.approx(
        100 * 177.999 / 320)


def test_a_short_idle_gap_does_not_cut(monkeypatch):
    """The host runs ahead: the loss's markers are launched at 2 and 3 ms
    and run behind a forward of 400 ms, across an idle gap of 0.5 ms (A to
    B) that is no cut, though no marker was launched near it."""
    step = span("train.step", ms(0.995), ms(600), marks=(0, 3), launched=(ms(1), ms(600)))
    raw = [step, span("ctc.loss", ms(2), ms(3), step, marks=(1, 2), launched=(ms(2), ms(3)))]
    ops = [marker(1.01), ("A", ms(1.02), ms(400)), ("B", ms(400.5), ms(401)), marker(401),
           ("C", ms(401.01), ms(450)), marker(450), marker(600.005)]
    run = run_of(monkeypatch, raw, ops, 0, ms(1000))
    windows = spans.device_windows(spans.window_spans(run), run.trace_data)
    assert windows == {0: (BASE + ms(1.011), BASE + ms(600.005)),
                       1: (BASE + ms(401.001), BASE + ms(450))}


@pytest.mark.parametrize("ops", [
    TRAIN_OPS[:-1],  # the last marker lost
    TRAIN_OPS[:5] + TRAIN_OPS[6:],  # the loss's exit marker lost, mid-window
    [marker(40)] + TRAIN_OPS[1:],  # a marker that ran before its launch
    [marker(99.7)] + TRAIN_OPS,  # a marker no span launched
], ids=["last_lost", "middle_lost", "early", "extra"])
def test_markers_that_do_not_pair_give_nothing(monkeypatch, ops):
    run = run_of(monkeypatch, train_spans(), ops, 0, ms(1000))
    windows = spans.device_windows(spans.window_spans(run), run.trace_data)
    assert not {0, 2, 3} <= set(windows)  # train.step, ctc.loss, ctc.loss.bwd
    assert harness.load_metric("ctc.share.train").read(run) is None


def test_nested_and_adjacent_windows_merge():
    assert spans.merge([(5, 9), (0, 3), (3, 4), (6, 7), (12, 12)]) == [(0, 4), (5, 9)]
    ops = [("x", 0, 10), ("y", 5, 15)]
    assert spans.covered(ops, [(2, 8), (4, 12), (12, 20)]) == 13
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10


def decode_spans():
    out = []
    for k, t0 in enumerate((0, 200 * MS)):
        batch = span("decode.batch", t0, t0 + 100 * MS)
        unpack = (15, 10)[k]
        out += [batch,
                span("decode.unpack", t0 + 40 * MS, t0 + (40 + unpack) * MS, batch),
                span("decode.rebuild", t0 + 60 * MS, t0 + 90 * MS, batch)]
    # a stream's decode outside any batch, which the batch metric leaves out
    out.append(span("decode.unpack", 320 * MS, 330 * MS))
    return out


DECODE_OPS = [("scan", 0, 45 * MS), ("copy", 200 * MS, 245 * MS), ("late", 325 * MS, 326 * MS)]


def test_walk_ms_is_the_mean_of_each_batchs_unpack_and_rebuild(monkeypatch):
    run = run_of(monkeypatch, decode_spans(), DECODE_OPS, 0, 400 * MS)
    # (15 + 30) and (10 + 30) ms
    assert harness.load_metric("decode.walk_ms.batch").read(run) == pytest.approx(42.5)


def test_walk_idle_is_the_gaps_while_the_host_walks(monkeypatch):
    run = run_of(monkeypatch, decode_spans(), DECODE_OPS, 0, 400 * MS)
    # walks [40, 55] (to 45 busy), [60, 90], [240, 250] (to 245 busy),
    # [260, 290] and [320, 330] (1 busy): 10 + 30 + 5 + 30 + 9
    assert harness.load_metric("decode.walk_idle.batch").read(run) == pytest.approx(
        100 * 84 / 400)


def test_pool_rounds(monkeypatch):
    raw = []
    for k, (emitting, beam_ms) in enumerate(((3, 2), (1, 9), (0, None), (2, 5))):
        t0 = 100 * k * MS
        r = span("pool.round", t0, t0 + 50 * MS,
                 **{"pool.slots": 4, "pool.slots_emitting": emitting})
        raw.append(r)
        if beam_ms:
            raw.append(span("pool.beam", t0 + 10 * MS, t0 + (10 + beam_ms) * MS, r))
    run = run_of(monkeypatch, raw, [("k5", 0, MS)], 0, 400 * MS)
    # beams of 2, 9 and 5 ms; 6 of 16 slots emitting
    assert harness.load_metric("pool.beam_issue_ms_p50").read(run) == pytest.approx(5.0)
    assert harness.load_metric("pool.round_fill").read(run) == pytest.approx(100 * 6 / 16)


def test_spans_outside_the_window_are_left_out(monkeypatch):
    run = run_of(monkeypatch, decode_spans(), DECODE_OPS, 150 * MS, 400 * MS)
    assert harness.load_metric("decode.walk_ms.batch").read(run) == pytest.approx(40.0)


@pytest.mark.parametrize("metric", ["ctc.share.train", "ctc.idle.train", "decode.walk_ms.batch",
                                    "decode.walk_idle.batch", "pool.beam_issue_ms_p50",
                                    "pool.round_fill"])
def test_no_spans_no_number(monkeypatch, metric):
    """A program without the tracer (the parent of this reader) reads
    nothing and raises nothing."""
    run = run_of(monkeypatch, [], TRAIN_OPS, 0, ms(1000))
    assert harness.load_metric(metric).read(run) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert harness.load_metric(metric).read(SimpleNamespace(trace_data=None)) is None


def test_the_clock_is_the_one_that_holds_the_trace(monkeypatch):
    ops = [("op", BASE // 2 + 100, BASE // 2 + 200)]
    raw = [span("x", 120, 150)]
    run = SimpleNamespace(trace_data={"intervals": ops, "lo": 0, "hi": BASE})
    monkeypatch.setattr(spans, "recorded", lambda: (raw, ANCHOR))
    now = {"time": BASE + 1000, "monotonic": BASE // 2 + 1000, "perf": 1000}
    [got] = spans.window_spans(run, now=now)
    # the monotonic clock holds the trace: 120 and 150 past its anchor
    assert (got.start, got.end) == (BASE // 2 + 120, BASE // 2 + 150)


def test_an_idle_gap_takes_the_name_of_what_the_host_did_most():
    """The harness's feeds hold the program's round, which holds its beam
    issue; the harness's wait for the next tick holds nothing. Each moment
    of a gap counts for the innermost span open then (the one begun last),
    or for "harness" where none is; the gap takes the name with the most.
    A gap that opens in the tick's last feed and runs on through the wait
    is the wait's."""
    opened = [("pool.feed", 0, 100), ("pool.round", 10, 50), ("pool.beam", 20, 30),
              ("pool.feed", 110, 120), ("pool.wait", 130, 300)]
    gaps = [(22, 40), (15, 32), (60, 100), (115, 290), (300, 400), (95, 127)]
    assert harness.name_gaps(gaps, opened) == [
        ("pool.round", 18e-9), ("pool.beam", 17e-9), ("pool.feed", 40e-9),
        ("pool.wait", 175e-9), ("harness", 100e-9), ("harness", 32e-9)]
