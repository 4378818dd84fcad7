"""The feature encoder's share of the wav2vec 2.0 forward's device time: the
device time between the markers of the program's `w2v2.features` spans
(the seven convolutions and the projection) over that between the markers
of its `w2v2.forward` spans, over the traced window's forwards whose
markers all paired; each moment counted once. A program without the spans
reads nothing."""

from port_bench import spans

UNIT = "%"
SOURCE = "program_span"
LAYER = "wav2vec2 acoustic model (models/wav2vec2.py)"
MOVES = "transcribe_audio_s_per_s"
PART = "w2v2.features"


def read(run):
    got = spans.window_spans(run)
    if got is None:
        return None
    ops = spans.work(run.trace_data)
    forwards, parts, _ = spans.step_windows(got, run.trace_data, "w2v2.forward", (PART,))
    whole = spans.covered(ops, forwards)
    return 100 * spans.covered(ops, parts) / whole if whole else None
