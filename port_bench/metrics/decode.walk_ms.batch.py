"""The host's walk of a batch's backpointers: the host time of the
program's `decode.unpack` (the packed plane into source and character
tables) and `decode.rebuild` (the walk into transcripts) spans under each
`decode.batch` span, the mean over the traced window's batches."""

from port_bench import spans

UNIT = "ms"
SOURCE = "program_span"
LAYER = "decode walk (decode/device.py unpack_bp, rebuild_results)"
MOVES = "transcribe_audio_s_per_s"


def read(run):
    got = spans.window_spans(run)
    if got is None:
        return None
    data = run.trace_data
    per_batch = {i: 0 for i, _ in spans.named(got, data, ("decode.batch",))}
    if not per_batch:
        return None
    for k, w in spans.named(got, data, ("decode.unpack", "decode.rebuild")):
        i = spans.ancestor(got, k, ("decode.batch",))
        if i in per_batch:
            per_batch[i] += w.end - w.start
    return sum(per_batch.values()) / len(per_batch) / 1e6
