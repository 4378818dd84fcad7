#!/usr/bin/env python3
"""The benchmark of stt_tpu_torch: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the cell's end-to-end metrics (--trace
0) or its per-layer metrics with the device's busy time and a breakdown
(--trace 1) as one JSON line, the last of standard output, after the
comparison with the plain reference that decides `correct`. Exits with
another code, and prints no result, without the CUDA devices the cell
asks for, or if JAX or the JAX package was loaded.
"""

import os
import sys
import time

STARTED = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(started=STARTED))
