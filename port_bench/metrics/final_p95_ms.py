"""The 95th percentile over all streams whose last piece was due in the
window of the time from that piece's due time to the return of
`finish_stream_with_metadata` with the transcript."""

import numpy as np

UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    latencies = run.records.get("final_latencies")
    if not latencies:
        return None
    return 1e3 * float(np.percentile(latencies, 95))
