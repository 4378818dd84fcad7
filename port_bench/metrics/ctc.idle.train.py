"""The card's idle time while the host is inside the CTC loss: the traced
window's idle gaps (between the union of every device operation) during
the program's `ctc.loss` and `ctc.loss.bwd` spans on the host, over the
window."""

from port_bench import spans

UNIT = "%"
SOURCE = "program_span"
LAYER = "CTC loss (ctc/loss.py, train/step.py)"
MOVES = "train_audio_s_per_s"


def read(run):
    got = spans.window_spans(run)
    if got is None:
        return None
    data = run.trace_data
    host = [(s.start, s.end) for _, s in spans.named(got, data, ("ctc.loss", "ctc.loss.bwd"))]
    if not host:
        return None
    return 100 * spans.idle_while(data, host) / (data["hi"] - data["lo"])
