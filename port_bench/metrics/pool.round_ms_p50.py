"""The median over the traced window's rounds of the time from the start of
the harness call in which a round fired to the completion on the card of
that call's work (the round and its slots' beam steps)."""

import numpy as np

UNIT = "ms"
SOURCE = "program_span"
LAYER = "stream pool (serve/pool.py)"
MOVES = "chunk_p95_ms"


def read(run):
    rounds = run.records.get("round_seconds")
    return 1e3 * float(np.median(rounds)) if rounds else None
