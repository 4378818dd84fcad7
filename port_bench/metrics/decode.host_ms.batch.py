"""The host's walk of the beam kernel's backpointers into transcripts
(`decode.device.rebuild_results`), summed over a batch's utterances by a
harness span around each call, the mean over the window's batches."""

import numpy as np

UNIT = "ms"
SOURCE = "program_span"
LAYER = "host rebuild (decode/device.py rebuild_results)"
MOVES = "transcribe_audio_s_per_s"


def read(run):
    ms = run.records.get("rebuild_ms")
    return float(np.mean(ms)) if ms else None
