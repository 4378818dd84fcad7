#!/usr/bin/env python3
"""The readings that a cell's comparison limits are set from, on the card:

    python3 port_bench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--variant-seeds 3] [--seconds 8]

For each seed, in one process: the cell's set-up and a window of
`--seconds` (the program's outputs), then the program's compared numbers
against the reference; for the first `--variant-seeds` seeds also the
numbers of the control (the reference one precision below) and of each
fault that the mix's module under drivers/ plants. One JSON line a seed.
A training cell's readings come from its set-up's first steps; its window
may be 0 seconds.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)
    harness.cache_environment()
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = harness.Run(args.workload, seed, args.seconds, trace=False)
        run.records["started"] = time.perf_counter()
        drv, ctx = harness.measure(run)
        drv.release(ctx)
        want = drv.reference(run, ctx)
        line = {"seed": seed, "program": drv.numbers(drv.program(run, ctx), want)}
        if i < args.variant_seeds:
            for name in drv.VARIANTS:
                line[name] = drv.variant(run, ctx, name, want)
        print(json.dumps(line), flush=True)
        del ctx, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
