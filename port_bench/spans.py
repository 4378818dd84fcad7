"""The program's own spans in a traced window: what `stt_tpu_torch.trace`
recorded while the harness's profiler session ran, on the clock of the
profiler's trace, and the arithmetic of the metrics that read them.

The tracer's anchor holds the host's three clocks read together; the
spans' perf_counter times move onto the one clock whose anchor reading and
reading now hold the median start of the trace's device operations, the
choice `harness.traced_window` makes. Spans marked for the device put an
empty kernel (`MARKER`) on the stream at their entry and exit, numbered in
one sequence: the trace's markers, in device order, pair with those
numbers in order between the card's long idle gaps (`device_windows`), and
the device work of a span is what ran between its two markers.

A program without the tracer, or a window in which it recorded nothing,
gives None, and so do the metrics that read it.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from port_bench import yardstick

MARKER = "spin_kernel"  # the device trace's name of the tracer's marker kernel
CLOCKS = ("time", "monotonic", "perf")
# an idle gap this long is the card with nothing queued: between queued
# operations the card idles for microseconds
IDLE_NS = 1_000_000
# the error of the clocks' mapping: on an H100 the trace's clock moved from
# the host's by up to 7.2 ms within a 20 s window, against launches of 10-70 us
SLACK_NS = 50_000_000


class Span(NamedTuple):
    name: str
    start: int  # host ns, on the device trace's clock
    end: int
    parent: Optional[int]  # index in the list, or None
    counters: dict
    attrs: dict
    marks: Optional[tuple]  # (number, launch's start, launch's end) of the entry and exit markers


def recorded():
    """(the program's closed spans, its anchor), or None."""
    try:
        from stt_tpu_torch import trace
    except ImportError:
        return None
    got, anchor = trace.spans(), trace.anchor()
    return (got, anchor) if got and anchor else None


def _clocks() -> dict:
    return {"time": time.time_ns(), "monotonic": time.monotonic_ns(),
            "perf": time.perf_counter_ns()}


def window_spans(run, now: Optional[dict] = None) -> Optional[List[Span]]:
    """Every span the program recorded, on the trace's clock, or None."""
    got, data = recorded(), run.trace_data
    if got is None or not data or not data["intervals"]:
        return None
    raw, anchor = got
    starts = sorted(s for _, s, _ in data["intervals"])
    mid = starts[len(starts) // 2]
    now = now or _clocks()
    clock = next((k for k in CLOCKS if anchor[k] <= mid <= now[k]), None)
    if clock is None:
        return None
    offset = anchor[clock] - anchor["perf"]
    index = {id(s): i for i, s in enumerate(raw)}
    return [Span(s.name, s.start + offset, s.end + offset,
                 index.get(id(s.parent)) if s.parent is not None else None,
                 dict(s.counters), dict(s.attrs),
                 tuple((n, b + offset, e + offset) for n, b, e in s.marks) if s.marks else None)
            for s in raw]


def named(spans: List[Span], data: dict, names) -> List[Tuple[int, Span]]:
    """(index, span) of the spans called any of `names` that lie in the
    traced window."""
    return [(i, s) for i, s in enumerate(spans)
            if s.name in names and data["lo"] <= s.start and s.end <= data["hi"]]


def device_windows(spans: List[Span], data: dict) -> Dict[int, Tuple[int, int]]:
    """{span index: (end of its entry marker, start of its exit marker)} on
    the device, for the spans whose two markers pair without doubt.

    The card idle for IDLE_NS or more, between the union of every device
    operation, had nothing queued: a marker enqueued before such a gap ran
    before it, and one enqueued in it would have run in it. So a launch
    that began after the gap's start and ended before its end (SLACK_NS
    within) lost its marker, and where no launch runs across the gap, it
    cuts the markers and the spans' marker launches in two. Between two
    cuts the markers pair in order with the launches in the order of their
    numbers, where they are as many and none ran more than SLACK_NS before
    its launch began; elsewhere (a marker lost while the card was busy, or
    one that no span launched) none pairs."""
    markers = sorted((s, e) for name, s, e in data["intervals"] if MARKER in name)
    events = sorted((mark, i, side) for i, s in enumerate(spans) if s.marks
                    for side, mark in enumerate(s.marks))
    began = [b for (_, b, _), _, _ in events]
    ended = [e for (_, _, e), _, _ in events]
    starts = [s for s, _ in markers]
    _, gaps = yardstick.union_ns(data["intervals"], data["lo"], data["hi"])
    cuts = []  # (markers before the gap, launches before it, launches before its end)
    for a, b in gaps:
        if b - a >= IDLE_NS:
            before = bisect.bisect_right(began, a + SLACK_NS)
            in_gap = bisect.bisect_left(ended, b - SLACK_NS)
            if before <= in_gap:
                cuts.append((bisect.bisect_left(starts, a), before, in_gap))
    opened: Dict[int, int] = {}
    out = {}
    m0 = e0 = 0
    for m1, e1, e2 in cuts + [(len(markers), len(events), len(events))]:
        pairs = list(zip(events[e0:e1], markers[m0:m1]))
        if m1 - m0 == e1 - e0 and all(start >= b - SLACK_NS
                                      for ((_, b, _), _, _), (start, _) in pairs):
            for (_, i, side), (start, end) in pairs:
                if side == 0:
                    opened[i] = end
                elif i in opened:
                    out[i] = (opened.pop(i), start)
        m0, e0 = m1, e2
    return out


def ancestor(spans: List[Span], i: int, names) -> Optional[int]:
    """The index of the innermost span above span i called any of `names`."""
    parent = spans[i].parent
    while parent is not None and spans[parent].name not in names:
        parent = spans[parent].parent
    return parent


def step_windows(spans: List[Span], data: dict, step: str, parts) -> tuple:
    """(the device windows of the traced window's `step` spans whose own
    markers and those of every span under them called any of `parts`
    paired, the windows of those parts, the number of `step` spans in the
    window)."""
    windows = device_windows(spans, data)
    under: Dict[int, list] = {}
    for k, _ in named(spans, data, parts):
        under.setdefault(ancestor(spans, k, (step,)), []).append(k)
    steps = named(spans, data, (step,))
    read = [i for i, _ in steps if i in windows and under.get(i)
            and all(k in windows for k in under[i])]
    return ([windows[i] for i in read], [windows[k] for i in read for k in under[i]], len(steps))


def work(data: dict) -> list:
    """The trace's device operations other than the markers."""
    return [op for op in data["intervals"] if MARKER not in op[0]]


def merge(windows) -> List[Tuple[int, int]]:
    """The union of (start, end) windows as disjoint windows, in order:
    windows that overlap or touch become one."""
    out: List[List[int]] = []
    for a, b in sorted(windows):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(ops: list, windows) -> int:
    """Nanoseconds of the union of the operations inside the union of the
    windows: each moment counted once."""
    return sum(yardstick.union_ns(ops, a, b)[0] for a, b in merge(windows))


def overlap(first, second) -> int:
    """Nanoseconds in both unions of windows."""
    a, b = merge(first), merge(second)
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_while(data: dict, windows) -> int:
    """Nanoseconds of the window's idle gaps (between the union of every
    device operation, as `harness.idle_percent` counts them) while the host
    was inside `windows`."""
    _, gaps = yardstick.union_ns(data["intervals"], data["lo"], data["hi"])
    return overlap(gaps, windows)
