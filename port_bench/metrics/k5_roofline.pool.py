"""K5's share of its roofline in the stream pool: the least time of the
prefix beam search over the frames the pool emitted in the traced window,
in one call per slot and round or flush step (yardstick.beam_bound_ms,
bytes), over the device time of the beam kernel in that window."""

from port_bench import harness, yardstick

UNIT = "%"
SOURCE = "device_trace"
LAYER = "K5 (ops/beam_kernel.py, decode/device.py)"
MOVES = "chunk_p95_ms"
KERNELS = ("beam_scan_kernel",)


def read(run):
    seconds = harness.kernel_seconds(run, KERNELS)
    r = run.records
    if not seconds or not r["beam_calls"]:
        return None
    bound = yardstick.beam_bound_ms(r["beam_calls"], r["emitted_frames"], r["beam"],
                                    run.cfg["n_out"])[0] / 1e3
    return 100 * bound / seconds
