"""The host's issue of a round's beam steps: the median over the traced
window's rounds of the host time of the program's `pool.beam` span (one K5
call per emitting slot, `StreamPool._dispatch_out`)."""

import numpy as np

from port_bench import spans

UNIT = "ms"
SOURCE = "program_span"
LAYER = "stream pool (serve/pool.py)"
MOVES = "chunk_p95_ms"


def read(run):
    got = spans.window_spans(run)
    if got is None:
        return None
    issue = [s.end - s.start for _, s in spans.named(got, run.trace_data, ("pool.beam",))]
    return float(np.median(issue)) / 1e6 if issue else None
