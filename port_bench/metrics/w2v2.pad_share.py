"""The share of the wav2vec 2.0 forward's frames that are padding: 1 - the
sum of the program's counter `w2v2.valid_frames` over the sum of
`w2v2.frames` (rows times the batch's frames), on the `w2v2.forward` spans
of the traced window. A program without the counters reads nothing."""

from port_bench import spans

UNIT = "%"
SOURCE = "program_counter"
LAYER = "wav2vec2 acoustic model (models/wav2vec2.py)"
MOVES = "transcribe_audio_s_per_s"


def read(run):
    got = spans.window_spans(run)
    if got is None:
        return None
    counted = [s.counters for _, s in spans.named(got, run.trace_data, ("w2v2.forward",))
               if "w2v2.frames" in s.counters]
    total = sum(c["w2v2.frames"] for c in counted)
    if not total:
        return None
    return 100 * (1 - sum(c.get("w2v2.valid_frames", 0) for c in counted) / total)
