"""wav2vec 2.0 batch transcription's share of the card's float32 peak: the
forward's operations over every utterance transcribed in the traced window,
counted over its valid samples and frames (yardstick_w2v2.forward_flops:
~770 MFLOP a frame at 500 frames at the configuration's widths), over the
traced window, against 67 TFLOP/s."""

from port_bench import yardstick, yardstick_w2v2

UNIT = "%"
SOURCE = "device_trace"
LAYER = "wav2vec2 acoustic model (models/wav2vec2.py)"
MOVES = "transcribe_audio_s_per_s"


def read(run):
    samples = run.records.get("samples")
    if not samples:
        return None
    flops = sum(yardstick_w2v2.forward_flops(run.cfg, n) for batch in samples for n in batch)
    return 100 * flops / run.trace_data["window_s"] / yardstick.PEAK_OPS_PER_S[run.cfg["dtype"]]
