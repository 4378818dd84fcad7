"""The card's idle time while the host walks the backpointers: the traced
window's idle gaps (between the union of every device operation) during
the program's `decode.unpack` and `decode.rebuild` spans on the host, over
the window."""

from port_bench import spans

UNIT = "%"
SOURCE = "program_span"
LAYER = "decode walk (decode/device.py unpack_bp, rebuild_results)"
MOVES = "transcribe_audio_s_per_s"


def read(run):
    got = spans.window_spans(run)
    if got is None:
        return None
    data = run.trace_data
    host = [(s.start, s.end)
            for _, s in spans.named(got, data, ("decode.unpack", "decode.rebuild"))]
    if not host:
        return None
    return 100 * spans.idle_while(data, host) / (data["hi"] - data["lo"])
