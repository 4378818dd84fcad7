"""What every cell's run shares: the manifest, the check for the card, the
cache directories, the window, the profiler's trace and its reduction,
the metrics' readers, the comparison's limits and the result line.

A cell is `workloads/<name>.json` (its configuration, its traffic mix, its
traced window and the limits of its comparison); the configuration is
`configs/<name>.json`; the mix is `traffic/<name>.json`, whose `driver`
names the entry of the program that it drives (`drivers/<driver>.py`);
each metric is `metrics/<name>.py`. BENCHMARK.json, at the root of the
checkout, says which metrics each cell reports.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "stt_tpu")  # top-level module names, whole


def cache_environment() -> None:
    """Keep every build and kernel cache at a fixed place in the checkout:
    the program's nvcc libraries already go to build/kernels/."""
    build = os.path.join(ROOT, "build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(build, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The end-to-end or per-layer metrics that `cell` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}",
                                                  os.path.join(HERE, "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(traffic: dict):
    return importlib.import_module(f"port_bench.drivers.{traffic['driver']}")


def cell_driver(cell: str):
    """The module under drivers/ that the cell's traffic mix names."""
    from port_bench import generator

    return driver(generator.load_json("traffic", generator.load_json("workloads", cell)["traffic"]))


class Run:
    """One run of one cell: its inputs, the spans the harness records
    around the program's calls, and what the window measured."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, device="cuda",
                 workload: Optional[dict] = None, cfg: Optional[dict] = None,
                 traffic: Optional[dict] = None):
        from port_bench import generator

        self.cell = cell
        self.workload = workload or generator.load_json("workloads", cell)
        self.cfg = cfg or generator.load_json("configs", self.workload["config"])
        self.traffic = traffic or generator.load_json("traffic", self.workload["traffic"])
        self.seed = int(seed) % (1 << 63)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.spans: List[tuple] = []  # (name, perf_counter start, end)
        self.records: Dict[str, object] = {}
        self.trace_data: Optional[dict] = None
        self.memory_peak = 0

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.trace:
                self.spans.append((name, start, time.perf_counter()))

    @property
    def is_cuda(self) -> bool:
        return str(self.device).startswith("cuda")

    def sync(self) -> None:
        if self.is_cuda:
            import torch

            torch.cuda.synchronize()

    def marker(self):
        """A point on the device's timeline: a CUDA event, or on the CPU the
        host's clock (its work is done when the call returns)."""
        if self.is_cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def times(self, start_marker, start_host: float, markers: list) -> List[float]:
        """Host-clock times of `markers`, after a synchronise, from the
        device's elapsed time since `start_marker` (taken at start_host)."""
        self.sync()
        if not self.is_cuda:
            return list(markers)
        return [start_host + start_marker.elapsed_time(m) / 1e3 for m in markers]

    def limits(self) -> dict:
        return self.workload["limits"]


def _clocks() -> dict:
    return {"time": time.time_ns(), "monotonic": time.monotonic_ns(),
            "perf": time.perf_counter_ns()}


def traced_window(run: Run, fn) -> None:
    """fn() under torch.profiler (the card's activity only, so the host's
    calls run at their untraced cost), then its reduction: each device
    operation's interval, the busy time (their union), the longest idle
    gaps and what the host was doing in each (`name_gaps`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench import spans, yardstick

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        c0 = _clocks()
        fn()
        torch.cuda.synchronize()
        c1 = _clocks()
    intervals = yardstick.kernel_intervals(prof)
    if not intervals:
        raise RuntimeError("the profiler recorded no operation on the card")
    starts = sorted(s for _, s, _ in intervals)
    mid = starts[len(starts) // 2]
    clock = next((k for k in c0 if c0[k] <= mid <= c1[k]), None)
    if clock is None:
        raise RuntimeError("the profiler's clock matches none of the host's")
    lo, hi = c0[clock], c1[clock]
    busy, gaps = yardstick.union_ns(intervals, lo, hi)
    offset = c0[clock] - c0["perf"]
    by_name: Dict[str, float] = {}
    for name, s, e in intervals:
        if e > lo and s < hi:
            by_name[name] = by_name.get(name, 0.0) + (min(e, hi) - max(s, lo)) / 1e9
    run.trace_data = {"intervals": intervals, "lo": lo, "hi": hi, "window_s": (hi - lo) / 1e9,
                      "busy_s": busy / 1e9, "by_name": by_name}
    opened = [(name, int(s * 1e9) + offset, int(e * 1e9) + offset) for name, s, e in run.spans]
    opened += [(s.name, s.start, s.end) for s in spans.window_spans(run) or []]
    run.trace_data["gaps"] = name_gaps(sorted(gaps, key=lambda g: g[0] - g[1])[:10], opened)


def name_gaps(gaps, opened) -> List[tuple]:
    """(name, seconds) of each idle gap (start, end): what the host did for
    the most of the gap. Each moment counts for the innermost of the
    `opened` spans (name, start, end; the harness's and the program's, on
    the trace's clock) open then, the one begun last, or for "harness"
    where none is."""
    out = []
    for s, e in gaps:
        inside = [o for o in opened if o[1] < e and o[2] > s]
        cuts = sorted({s, e} | {t for o in inside for t in o[1:] if s < t < e})
        spent: Dict[str, int] = {}
        for a, b in zip(cuts, cuts[1:]):
            inner = max((o for o in inside if o[1] <= a < o[2]), key=lambda o: o[1], default=None)
            name = inner[0] if inner else "harness"
            spent[name] = spent.get(name, 0) + b - a
        out.append((max(spent, key=spent.get) if spent else "harness", (e - s) / 1e9))
    return out


def kernel_seconds(run: Run, patterns) -> float:
    """Device seconds of the operations whose names hold any of `patterns`."""
    return sum(t for name, t in run.trace_data["by_name"].items()
               if any(p in name for p in patterns))


def idle_percent(run: Run) -> float:
    t = run.trace_data
    return 100 * (1 - t["busy_s"] / t["window_s"])


def breakdown(run: Run) -> dict:
    ops = sorted(run.trace_data["by_name"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:96], t] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in run.trace_data["gaps"]]}


def checks_of(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, list]:
    """{name: [number, limit]} for every limited number; a number that is
    missing or not finite reads as infinity."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is None or value != value:
            value = float("inf")
        out[name] = [float(value), float(limit)]
    return out


def measure(run: Run):
    """Set-up, the window (traced or not) and the reading of the device's
    peak memory. Returns the mix's module under drivers/ and its context."""
    import torch

    drv = driver(run.traffic)
    ctx = drv.setup(run)
    run.records["setup_end"] = time.perf_counter()
    if run.trace:
        seconds = min(run.seconds, float(run.workload["trace_seconds"]))
        traced_window(run, lambda: drv.window(run, ctx, seconds))
    else:
        drv.window(run, ctx, run.seconds)
    if run.is_cuda:
        run.memory_peak = int(torch.cuda.max_memory_allocated())
    return drv, ctx


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, started: Optional[float] = None) -> int:
    started = time.perf_counter() if started is None else started
    args = parse(argv)
    cache_environment()
    bench = manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(4)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace))
    run.records["started"] = started
    drv, ctx = measure(run)
    section = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, run.cell, section):
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted, failed = run.records["attempted"], run.records["failed"]
    drv.release(ctx)
    compared = time.perf_counter()
    numbers = drv.readings(run, ctx)
    print(f"timing: set-up {run.records['setup_end'] - started:.1f} s, window and trace "
          f"{compared - run.records['setup_end']:.1f} s, comparison "
          f"{time.perf_counter() - compared:.1f} s", file=sys.stderr)
    checks = checks_of(numbers, run.limits())
    correct = all(v <= lim for v, lim in checks.values()) and failed == 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": run.memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device}
    if run.trace:
        device["busy_s"] = run.trace_data["busy_s"]
        device["window_s"] = run.trace_data["window_s"]
        result["breakdown"] = breakdown(run)
    result["checks"] = checks
    leaked = forbidden_modules()
    if leaked:
        print(f"modules of JAX or of the JAX package were loaded: {leaked}", file=sys.stderr)
        return 4
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
