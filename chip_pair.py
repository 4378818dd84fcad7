"""Run `chip_smoke.py` in several unpacked trees of the repository one after
the other, in one call on the card, so that two versions are compared on
the same card and host: each run's wall seconds are printed, and each of
its output lines is written, with the seconds since that run's start, to
chiprun_out/pair_<n>_<tree>.log.

Run, from the root of a checkout, with the trees unpacked by `git archive`
into a directory that .gitignore lists:
    python3 chip_pair.py build/old build/new build/new build/old
Exits non-zero when a run does.
"""

import os
import subprocess
import sys
import time


def run(tree: str, log_path: str) -> tuple:
    """chip_smoke.py in `tree`, its lines stamped into `log_path`; returns
    (exit code, wall seconds)."""
    start = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tree, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for line in proc.stdout:
            log.write(f"{time.time() - start:8.1f} {line}")
            log.flush()
        rc = proc.wait()
    return rc, time.time() - start


def main(trees: list) -> int:
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    worst = 0
    for n, tree in enumerate(trees):
        log_path = os.path.join(out, f"pair_{n}_{os.path.basename(os.path.normpath(tree))}.log")
        rc, seconds = run(tree, log_path)
        with open(log_path) as f:
            last = f.read().splitlines()[-1:]
        print(f"{tree}: exit {rc}, {seconds:.1f} s; last line: {''.join(last)[:200]}", flush=True)
        worst = worst or rc
    return worst


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
