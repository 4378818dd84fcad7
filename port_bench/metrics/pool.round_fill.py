"""How full the stream pool's rounds are: the sum over the traced window's
rounds of the program's counter `pool.slots_emitting` (the slots whose
frames the round emits) over the sum of `pool.slots` (the slots each round
runs at, S)."""

from port_bench import spans

UNIT = "%"
SOURCE = "program_span"
LAYER = "stream pool (serve/pool.py)"
MOVES = "chunk_p95_ms"


def read(run):
    got = spans.window_spans(run)
    if got is None:
        return None
    rounds = [s.counters for _, s in spans.named(got, run.trace_data, ("pool.round",))]
    slots = sum(c.get("pool.slots", 0) for c in rounds)
    return 100 * sum(c.get("pool.slots_emitting", 0) for c in rounds) / slots if slots else None
