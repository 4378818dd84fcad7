"""Tiny versions of each cell for the CPU tests: the cell's configuration
and mix with the widths, sizes, beams and durations cut so that a run
takes seconds on the CPU. Nothing that runs on the card uses them.

Each mix's module under drivers/ declares its own cut, `TINY`: the keys of
the mix (`traffic`) and of the configuration (`cfg`) that it changes, and
the comparison's limits at that size (`limits`), set from CPU readings of
the program and of the control."""

from port_bench import generator, harness


def run(cell: str, seed: int = 2 ** 31 + 12345, seconds: float = 2.0) -> harness.Run:
    workload = generator.load_json("workloads", cell)
    traffic = generator.load_json("traffic", workload["traffic"])
    cut = harness.driver(traffic).TINY
    cfg = dict(generator.load_json("configs", workload["config"]), **cut["cfg"])
    traffic.update(cut["traffic"])
    workload = dict(workload, limits=cut["limits"])
    return harness.Run(cell, seed, seconds, False, device="cpu", workload=workload, cfg=cfg,
                       traffic=traffic)
