"""Audio-seconds of all the whole training steps in the window, over the
time from the window's start to the end of the last whole step on the card
(CUDA events, read after a synchronise)."""

UNIT = "audio-s/s"
SOURCE = "host_clock"


def read(run):
    r = run.records
    if not r.get("steps") or r["window_end"] is None:
        return None
    return r["audio_s"] / (r["window_end"] - r["window_start"])
