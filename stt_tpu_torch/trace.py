"""Spans and counters at the port's layer boundaries, recorded only while a
`torch.profiler` session is active.

    with trace.span("pool.round"):
        ...
        trace.count("pool.slots", n)

With no session, `span` returns one shared object that does nothing, and
`count` returns at once: an untraced call pays one check of
`torch.autograd.profiler._is_profiler_enabled`. During a session each span
records its name and attributes, its start and end on the host's
`time.perf_counter_ns()` clock, its thread and its parent, the innermost
span open on the same thread, and opens a `record_function` range of its
name, so a profiler trace (the trainer's `--profile_dir`) shows the layers.
A span opened on a thread with no span open, such as autograd's device
thread, takes as parent the innermost span then open on another thread.
Counters add to the innermost open span of their thread. `begin` opens a
span that another thread may close (`close()`), and that is no thread's
innermost span.

A span with `device=True` also puts a marker on the current CUDA stream at
its entry and its exit: an empty kernel (`torch.cuda._sleep(0)`, whose
kernel the trace names `spin_kernel`) that the device trace records with
its device time. A stream runs in launch order, so the device operations
between a span's two markers are the work it launched, however far the
host runs ahead. Each marker carries a number from one sequence and the
host's times before and after its launch. Spans on the CPU put no marker.

The first span of a session drops what earlier sessions recorded and
reads an anchor: `time.time_ns()`, `time.monotonic_ns()` and
`time.perf_counter_ns()` read together, so that a reader can map the spans
onto the clock of the profiler's trace. A session is new when a span was
asked for while no session was active since the last span recorded.
`spans()` returns what was recorded; `reset()` drops it and the anchor.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

MARKER = "spin_kernel"  # the device trace's name of the marker's kernel


class _Off:
    """The span of a call made while no profiler session is active."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def close(self) -> None:
        pass


OFF = _Off()

_spans: List["Span"] = []
_anchor: Optional[Dict[str, int]] = None
_between = True  # no session was active at some call since the last span recorded
_local = threading.local()
_stacks: Dict[int, list] = {}  # thread id: its open stacked spans
_stacks_lock = threading.Lock()
_marks = itertools.count()
_mark_lock = threading.Lock()


def enabled() -> bool:
    """Whether a profiler session is active, so that spans record."""
    return _profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        with _stacks_lock:
            _stacks[threading.get_ident()] = stack
    return stack


def _mark() -> tuple:
    """A marker on the current stream: (its number in the sequence, the
    host's perf_counter_ns() before and after its launch)."""
    with _mark_lock:
        before = time.perf_counter_ns()
        torch.cuda._sleep(0)
        return next(_marks), before, time.perf_counter_ns()


class Span:
    """One recorded span. `start` and `end` are perf_counter_ns() readings
    (`end` is None while open); `marks` holds (sequence number, host time
    before and after the launch) of its entry and exit markers, or is None."""

    __slots__ = ("name", "attrs", "start", "end", "tid", "parent", "counters", "marks",
                 "_device", "_range", "_stacked")

    def __init__(self, name: str, attrs: dict, device: bool, stacked: bool):
        self.name, self.attrs = name, attrs
        self._device = device and torch.cuda.is_initialized()
        self._stacked = stacked
        self.counters: Dict[str, int] = {}
        self.marks = None
        self.end = None

    def _open(self) -> "Span":
        global _anchor, _between
        if _between:
            _spans.clear()
            _anchor = {"time": time.time_ns(), "monotonic": time.monotonic_ns(),
                       "perf": time.perf_counter_ns()}
            _between = False
        stack = _stack()
        self.tid = threading.get_ident()
        if stack:
            self.parent = stack[-1]
        else:
            with _stacks_lock:
                tops = [top for t, s in _stacks.items() if t != self.tid for top in s[-1:]]
            self.parent = max(tops, key=lambda s: s.start, default=None)
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        if self._device:
            self.marks = (_mark(), None)
        self.start = time.perf_counter_ns()
        if self._stacked:
            stack.append(self)
        _spans.append(self)
        return self

    def close(self) -> None:
        end = time.perf_counter_ns()
        if self._device:
            self.marks = (self.marks[0], _mark())
        self._range.__exit__(None, None, None)
        self._range = None
        self.end = end  # last: a span with an end is whole
        if self._stacked:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()

    def __enter__(self) -> "Span":
        return self._open()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def span(name: str, device: bool = False, **attrs):
    """A context manager recording `name` with `attrs` during a profiler
    session, and doing nothing outside one."""
    global _between
    if not _profiler._is_profiler_enabled:
        _between = True
        return OFF
    return Span(name, attrs, device, stacked=True)


def begin(name: str, device: bool = False, **attrs):
    """An open span that any thread may end with `close()`. Outside a
    session, an object whose `close()` does nothing."""
    global _between
    if not _profiler._is_profiler_enabled:
        _between = True
        return OFF
    return Span(name, attrs, device, stacked=False)._open()


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of this thread's innermost open span."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _stack()
    if stack:
        counters = stack[-1].counters
        counters[name] = counters.get(name, 0) + n


def anchor() -> Optional[Dict[str, int]]:
    """The clocks read together at the session's first span, or None."""
    return _anchor


def spans() -> List[Span]:
    """The closed spans of the latest session, in the order they opened."""
    return [s for s in _spans if s.end is not None]


def reset() -> None:
    """Drop the recorded spans and the anchor: the next span starts anew."""
    global _anchor, _between
    _spans.clear()
    _anchor = None
    _between = True
