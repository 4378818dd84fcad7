#!/usr/bin/env python3
"""The stream pool's sweep over concurrent streams, on the card:

    python3 port_bench/sweep_pool.py --streams 96,160,224,288 [--seconds 12] [--seed N]

For each count, in one process: the pool-lockstep mix at that many streams
(set-up, then a window of `--seconds`), and one JSON line with the pieces'
latency (p50, p95), the finals' p95, the rounds' median, how late the
generator ran (p95, max), the backlog's growth (the median latency of the
window's last quarter of pieces less its first quarter's) and the pieces
never served. The count at which the pool keeps up is the largest whose
generator stays on time and whose backlog does not grow.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import generator, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--streams", required=True)
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--seed", type=int, default=20261018)
    p.add_argument("--workload", default="en-pool-devdecode")
    args = p.parse_args(argv)
    harness.cache_environment()
    base = generator.load_json("workloads", args.workload)
    for streams in (int(s) for s in args.streams.split(",")):
        traffic = dict(generator.load_json("traffic", base["traffic"]), streams=streams)
        run = harness.Run(args.workload, args.seed, args.seconds, False, traffic=traffic)
        run.records["started"] = time.perf_counter()
        drv, ctx = harness.measure(run)
        r = run.records
        order = np.argsort(r["piece_dues"])
        lat = np.asarray(r["piece_latencies"])[order] * 1e3
        quarter = max(1, len(lat) // 4)
        print(json.dumps({
            "streams": streams,
            "chunk_p50_ms": float(np.percentile(lat, 50)), "chunk_p95_ms": float(np.percentile(lat, 95)),
            "final_p95_ms": float(np.percentile(r["final_latencies"], 95)) * 1e3,
            "round_p50_ms": float(np.median(r["round_seconds"])) * 1e3,
            "late_p95_ms": float(np.percentile(r["lateness"], 95)) * 1e3,
            "late_max_ms": float(np.max(r["lateness"])) * 1e3,
            "backlog_growth_ms": float(np.median(lat[-quarter:]) - np.median(lat[:quarter])),
            "pieces": r["attempted"], "unserved": r["failed"],
            "setup_s": r["setup_end"] - r["started"]}), flush=True)
        drv.release(ctx)
        del ctx
    return 0


if __name__ == "__main__":
    sys.exit(main())
