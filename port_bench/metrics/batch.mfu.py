"""Batch transcription's share of the card's float32 peak: the forward's
matmul operations of every valid frame transcribed in the traced window
(yardstick.forward_flops_per_frame: 94.4 MFLOP at the release's widths)
over the traced window, against 67 TFLOP/s."""

from port_bench import yardstick

UNIT = "%"
SOURCE = "device_trace"
LAYER = "frontend and acoustic model (frontend/features.py, models/deepspeech.py)"
MOVES = "transcribe_audio_s_per_s"


def read(run):
    flops = run.records["frames"] * yardstick.forward_flops_per_frame(run.cfg)
    return 100 * flops / run.trace_data["window_s"] / yardstick.PEAK_OPS_PER_S[run.cfg["dtype"]]
