"""The 95th percentile over all pieces due in the window of the time from a
piece's due time on the cadence to the completion on the card of the round
that emits its frames (or the finish that flushes them). A piece never
served counts as failed."""

import numpy as np

UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    latencies = run.records.get("piece_latencies")
    if not latencies:
        return None
    return 1e3 * float(np.percentile(latencies, 95))
