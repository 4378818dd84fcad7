"""K1's share of its roofline in batch transcription: the least time of the
inference recurrence over each batch's shape (T = the padded batch's
frames, B rows, the valid steps; yardstick.recurrence_bounds "k1") over
the device time of its kernels in the traced window."""

from port_bench import generator, harness, yardstick

UNIT = "%"
SOURCE = "device_trace"
LAYER = "K1 (ops/lstm_kernel.py)"
MOVES = "transcribe_audio_s_per_s"
KERNELS = ("recurrence_kernel",)


def read(run):
    seconds = harness.kernel_seconds(run, KERNELS)
    if not seconds:
        return None
    bound = sum(yardstick.recurrence_bounds(
        "k1", int(generator.frames(width, run.cfg["features"])), rows, run.cfg["n_cell_dim"],
        valid, run.cfg["dtype"])[0] for rows, width, valid, _ in run.records["shapes"]) / 1e3
    return 100 * bound / seconds
