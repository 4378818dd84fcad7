"""The training step's share of the card's float32 peak: the forward's
and the backward's matmul operations of every valid frame of the traced
window's steps (yardstick.train_flops_per_frame: 283.25 MFLOP at the
release's widths) over the traced window, against 67 TFLOP/s."""

from port_bench import yardstick

UNIT = "%"
SOURCE = "device_trace"
LAYER = "train step (train/step.py, ctc/loss.py, models/deepspeech.py)"
MOVES = "train_audio_s_per_s"


def read(run):
    flops = run.records["frames"] * yardstick.train_flops_per_frame(run.cfg)
    return 100 * flops / run.trace_data["window_s"] / yardstick.PEAK_OPS_PER_S[run.cfg["dtype"]]
