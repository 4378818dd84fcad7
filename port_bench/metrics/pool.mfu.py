"""The stream pool's share of the card's float32 peak: the forward's matmul
operations of every frame the pool emitted in the traced window (rounds
and flushes) over the traced window, against 67 TFLOP/s."""

from port_bench import yardstick

UNIT = "%"
SOURCE = "device_trace"
LAYER = "stream pool (serve/pool.py)"
MOVES = "chunk_p95_ms"


def read(run):
    flops = run.records["emitted_frames"] * yardstick.forward_flops_per_frame(run.cfg)
    return 100 * flops / run.trace_data["window_s"] / yardstick.PEAK_OPS_PER_S[run.cfg["dtype"]]
