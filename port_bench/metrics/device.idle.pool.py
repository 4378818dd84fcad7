"""The card's idle share of the traced window of the stream pool: 1 - the
union of every device operation's interval over the window."""

from port_bench import harness

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "chunk_p95_ms"


def read(run):
    return harness.idle_percent(run)
