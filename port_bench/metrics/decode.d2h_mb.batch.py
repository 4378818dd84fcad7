"""What the batch decode copies from the card to the host: the program's
counter `decode.d2h_bytes` on each `decode.batch` span of the traced
window, the mean over the batches that carry it, in MB (10^6 bytes). A
program without the counter reads nothing."""

from port_bench import spans

UNIT = "MB"
SOURCE = "program_counter"
LAYER = "decode walk (decode/device.py unpack_bp, rebuild_results)"
MOVES = "transcribe_audio_s_per_s"


def read(run):
    got = spans.window_spans(run)
    if got is None:
        return None
    counted = [s.counters["decode.d2h_bytes"]
               for _, s in spans.named(got, run.trace_data, ("decode.batch",))
               if "decode.d2h_bytes" in s.counters]
    return sum(counted) / len(counted) / 1e6 if counted else None
