#!/usr/bin/env python3
"""One run of a cell as run.py makes it, with one of the faults that its
mix's driver plants (`FAULTS`) in the program: its result line must read
`correct` false.

    python3 port_bench/planted.py --fault <name> --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>
"""

import argparse
import importlib
import os
import sys
import time

STARTED = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fault", required=True)
    args, rest = p.parse_known_args(argv)
    cell = harness.parse(rest).workload
    harness.cache_environment()
    module, name, make = harness.cell_driver(cell).FAULTS[args.fault]
    module = importlib.import_module(module)
    setattr(module, name, make(getattr(module, name)))
    return harness.main(rest, started=STARTED)


if __name__ == "__main__":
    sys.exit(main())
