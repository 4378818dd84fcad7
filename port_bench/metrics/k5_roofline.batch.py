"""K5's share of its roofline in batch transcription: the least time of the
prefix beam search over each batch's utterances and valid frames at the
mix's beam (yardstick.beam_bound_ms, bytes) over the device time of the
beam kernel in the traced window."""

from port_bench import harness, yardstick

UNIT = "%"
SOURCE = "device_trace"
LAYER = "K5 (ops/beam_kernel.py, decode/device.py)"
MOVES = "transcribe_audio_s_per_s"
KERNELS = ("beam_scan_kernel",)


def read(run):
    seconds = harness.kernel_seconds(run, KERNELS)
    if not seconds:
        return None
    bound = sum(yardstick.beam_bound_ms(rows, valid, run.records["beam"], run.cfg["n_out"])[0]
                for rows, _, valid, _ in run.records["shapes"]) / 1e3
    return 100 * bound / seconds
