"""The CTC loss's share of the train step's device time: the device time
between the markers of the program's `ctc.loss` and `ctc.loss.bwd` spans
(the loss's forward, and its backward from its output's gradient to the
logits') over the device time between the markers of its `train.step`
spans, over the traced window's steps whose markers all paired; each
moment counted once."""

from port_bench import spans

UNIT = "%"
SOURCE = "program_span"
LAYER = "CTC loss (ctc/loss.py, train/step.py)"
MOVES = "train_audio_s_per_s"


def read(run):
    got = spans.window_spans(run)
    if got is None:
        return None
    ops = spans.work(run.trace_data)
    steps, loss, _ = spans.step_windows(got, run.trace_data, "train.step",
                                        ("ctc.loss", "ctc.loss.bwd"))
    step = spans.covered(ops, steps)
    return 100 * spans.covered(ops, loss) / step if step else None
