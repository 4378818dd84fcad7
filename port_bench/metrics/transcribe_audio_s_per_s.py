"""Audio-seconds transcribed in the window, from audio on the card to
transcripts on the host, over the time from the window's start to the
return of its last whole batch."""

UNIT = "audio-s/s"
SOURCE = "host_clock"


def read(run):
    r = run.records
    if not r.get("audio_s") or r["window_end"] is None:
        return None
    return r["audio_s"] / (r["window_end"] - r["window_start"])
